// Fused active pass (K1): one active-set block-CD pass over the visit order,
// for the least-squares, weighted least-squares and sqrt-lasso kinds, float
// and double, in one kernel launch (the kind is a template argument: the
// least-squares instantiation carries none of the others' code).
//
// Replaces coordinatedescent_jl_tpu/ops/pallas_block.py:fused_active_pass
// (its kernels _make_chunked_kernel and _make_resident_kernel).  On the TPU
// the grid steps run in order on one core, with n_active and the order
// brought in by scalar prefetch, and beta and r stay resident in VMEM for
// the whole pass: visit t+1 reads the r that visit t wrote.  Here one
// launch of G CTAs (G from kernels/active_pass.py::plan_active_pass) runs
// the whole pass, by one of two routes that the plan chooses from n, B, the
// dtype and whether the Gram is cached:
//   - the cooperative route (the chunked kernel's counterpart, e.g. n = 10K):
//     a co-resident grid of up to one CTA per SM (cudaLaunchCooperativeKernel),
//     grid barriers (cooperative groups' grid.sync()), the CTAs' partial sums
//     exchanged through global scratch (L2);
//   - the cluster route (the resident kernel's counterpart, _resident_pass,
//     small n): where G <= 16 CTAs of at most 64 rows keep every row of r
//     and of X_b in shared memory, the G CTAs are one thread-block cluster
//     (cudaLaunchKernelEx with a cluster dimension of G; no co-residency
//     query, no scratch).  Each CTA leaves its partial sums in its own
//     shared memory and the others read them there (distributed shared
//     memory, `mapa`), in the same order and with the same arithmetic as
//     the cooperative route reads them from L2, so the two routes give the
//     same bits at the same G and rows.  A visit's barrier is an mbarrier
//     in each CTA that every CTA arrives on once (release at cluster
//     scope), not a barrier of all G x 512 threads; the block's Gram is
//     copied once for the cluster, each CTA issuing B / G of its rows as
//     bulk copies multicast to every CTA (the Tensor Memory Accelerator,
//     completing on a second mbarrier) as the visit starts; the CTAs then
//     arrive, with nothing to release, at the hardware cluster barrier
//     once done with the partials and the Gram, and wait for it as the
//     next visit starts, by when it is complete (no CTA overwrites or
//     leaves what another still reads);
// Both routes (the visit skeleton, common.cuh, shared with GP):
//   - the visit order is found on the device: every CTA walks `border` and
//     takes the next block whose `active` flag is set (a warp ballot over
//     32 entries at a time, during the previous visit's residual update),
//     so the host reads nothing, and with no active block the kernel only
//     writes its outputs;
//   - CTA g owns rows [g R, g R + R) of r for the whole pass, in shared
//     memory when the plan keeps them (else in its rows of r_out), and
//     writes them to r_out at the end: the counterpart of the TPU kernel's
//     VMEM retention (pallas_block.py:12-20, _retention_fits);
//   - per visit each CTA reads its rows of X_b once with 16-byte loads,
//     keeping them in shared memory when they fit (the plan's keep_x; else
//     the residual update reads them again, from L2), writes its B partial
//     sums of c = X_b' r (double-buffered by visit parity, so visit t+1
//     cannot overwrite what a slow CTA still reads for visit t) and, with
//     no cached Gram, its partial Gram over its rows; then a barrier;
//     without a Gram the CTAs next add the G partial Grams, each a slice of
//     the entries in CTA order, and meet at a second barrier;
//   - every CTA then solves the block redundantly: the same partials added
//     in the same order, the same Gram (from L2: the working set's 8 Grams
//     are 512 KB) and the same code give every CTA a bit-identical d, so
//     one barrier per visit suffices and no CTA waits for a published d;
//     FISTA with a Gershgorin step (inner = ista; the momentum sequence,
//     the same at every visit, read from the host's table `mom`, a load
//     off the step's chain): a warp owns 8
//     coordinates and holds their Gram columns in registers for the whole
//     solve (read once from L2), each lane 4 rows; a step reads the
//     extrapolated point once per warp (one 16-byte load a lane, distinct
//     addresses), and the lanes' partial sums meet in a fixed-order
//     reduce-scatter of shuffles, one __syncthreads per step.  (With the
//     columns in shared memory, each step re-read B^2 Gram entries and
//     each lane a quarter of the point: shared-memory bound, 4-5x slower
//     on the H100.)  Or the exact Gauss-Seidel scan in `corder` through the
//     Gram recursion (inner = exact), on the first 4 warps from a copy of
//     the Gram in shared memory (cp.async, issued before the grid barrier),
//     each coordinate's divisions done before the scan, the next
//     coordinate's constants read ahead, one 128-thread barrier per
//     coordinate;
//   - each CTA updates its own rows, r -= X_b d, from the rows it kept.
// Every sum is in a fixed order: no atomics, deterministic.
//
// The weighted kind (wls) has a second design, Xw = diag(w) X: c = Xw_b' r
// and, with no cached Gram, K = Xw_b' X_b read the weighted rows, once; the
// rows a CTA keeps in shared memory, and the residual update, are the
// unweighted X_b's (pallas_block.py:428, 439-444, 471-473).
//
// The sqrt kind threads ||r||^2 through the pass and returns it:
//   - inner = ista: the threshold scale of a visit is lam0 sqrt(max(||r||^2,
//     1e-30)) with the ||r||^2 that stands at its start (the input's for the
//     first visit), and after the residual update ||r||^2 is rebuilt from
//     the new r (pallas_block.py:451-453, 475-480).  Each CTA owns a slice
//     of r, so it writes the sum of squares of its slice beside the partial
//     c of the next visit (double-buffered by parity like them), and after
//     the next visit's grid barrier every CTA adds the G partials in one
//     fixed order: every CTA holds the same threshold, and the rebuild costs
//     no barrier of its own.  Only the pass's last visit needs one more
//     barrier, before CTA 0 adds the partials into the output;
//   - inner = exact: the scan is the three-branch closed-form minimizer
//     (block_cd._sqrt_candidate) with the running ||r||^2 carried through
//     the B coordinates and from visit to visit, in every CTA alike; no
//     rebuild.  Each operation of the candidate is rounded on its own
//     (__fmul_rn and friends, IEEE square roots and divisions), in the
//     expression order of _sqrt_candidate: the zero test |s| > lam
//     sqrt(rsb) decides the support, and the plain twin rounds that way.
//
// What bounds it on an H100: with a cached Gram (the working-set solve,
// the main path) a visit reads the (n, B) block once, 2 n B sizeof(T)
// bytes spread over G CTAs, plus the B x B Gram per CTA from L2, for
// 4 n B + 2 iters B^2 flops: the latency of one grid barrier, the L2 read
// of the Gram and the solve's chain of iters steps, per visit, not the
// bytes.  Without a Gram each visit adds 2 n B^2 flops, G partial Grams
// (through L2, or through distributed shared memory on the cluster route)
// and a second barrier.  At n = 500 (the varying-coefficient scan, one block
// of 128) the bytes are ~0.3 MB: the launch, the barriers and the solve's
// chain are all of it, hence the cluster route (its phases by SM clock:
// kernel_ab.py --stamps, PERF.md).  grid.sync() and the
// cluster barrier build under the plain per-source `nvcc -c` (no -rdc) with
// CUDA 12.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace cdt {

// The CTA is common.cuh's DOT_THREADS: the solve's DOT_MAXB coordinates x
// AP_QUAD threads.
constexpr int AP_QUAD = 4;       // threads per coordinate in the solve
constexpr int AP_NVEC = 9;       // B-long vectors in shared memory
constexpr int AP_KCH = 8;        // partial-Gram columns per sweep of rows
constexpr int AP_GBATCH = 4;     // Gram loads in flight per thread
constexpr int AP_RS = 24;        // slot of `red` that holds the running
                                 // ||r||^2 (block reductions use 0..15)
constexpr int KIND_LS = 0, KIND_WLS = 1, KIND_SQRT = 2;

// The Gram in shared memory: row l starts at l ld + V ((l / 4) % 8), ld =
// B + 8 V (V = 16 / sizeof(T)), so that the rows 4 apart that the lanes
// of a warp read in the FISTA product (4 L + i) fall in distinct banks,
// and every row stays 16-byte aligned (cp.async, 16-byte loads).
template <typename T>
__host__ __device__ inline int gram_ld(int B) { return B + 8 * vec_of<T>(); }
template <typename T>
__device__ __forceinline__ int grow(int l, int ld) {
  return l * ld + vec_of<T>() * ((l >> 2) & 7);
}

// Shared-memory layout, offsets in elements of T after a 16-byte header
// of ints; kernels/active_pass.py::plan_active_pass computes the same
// bytes.  `scr` holds the row groups' sums of c while the CTA sweeps its
// rows, then the solve's vectors (FISTA's extrapolated point, the exact
// scan's beta), which are never live at the same time.  The cluster route
// (`cl`) adds what the other CTAs read of this one: its partial c's by
// visit parity (`pc`), its partial ||r||^2 by parity (`prs`, sqrt; its
// second 16 bytes hold the mbarrier the Gram's copies complete on) and,
// without a cached Gram, its slice of the summed Gram (`ks`, ceil(B^2 / G)
// entries; the CTA's partial Gram is left in `K` itself).  All three are
// empty on the cooperative route, whose offsets are unchanged by them.
struct ApLayout {
  int scr, pc, prs, ks, xs, K, vecs, red, rs;
  size_t bytes;
};

// entries of the summed Gram in one CTA's slice (cluster route, no Gram)
inline __host__ __device__ int ks_per(int B, int G) {
  return (B * B + G - 1) / G;
}

template <typename T>
__host__ __device__ inline ApLayout ap_layout(int B, int rows, int keep_x,
                                              int keep_r, int cl, int gram,
                                              int G) {
  constexpr int V = vec_of<T>();
  ApLayout L;
  int o = 0;
  L.scr = o;  o += DOT_THREADS * V;                // see above
  L.pc = o;   o += cl ? 2 * B : 0;                 // partial c, 2 parities
  L.prs = o;  o += cl ? 2 * V : 0;                 // partial ||r||^2, mbarrier
  L.ks = o;   o += cl && !gram ? vec_up<T>(ks_per(B, G)) : 0;
  L.xs = o;   o += keep_x ? rows * B : 0;          // the kept rows of X_b
  L.K = o;    o += B * gram_ld<T>(B);              // the block's Gram
  L.vecs = o; o += AP_NVEC * B;                    // c, beta0, lamw, ...
  L.red = o;  o += 32;                             // block_max slots
  L.rs = o;   o += keep_r ? rows : 0;              // the CTA's rows of r
  L.bytes = 16 + sizeof(T) * (size_t)o;
  return L;
}

// dst[grow(l) + k] = src[l B + k] for the B x B Gram at src, with batches of
// AP_GBATCH loads in flight per thread, 16 bytes each when `vec` (src 16-byte
// aligned and B a multiple of 16 / sizeof(T), so that no load crosses a
// row and every padded row of dst starts 16-byte aligned).  `coherent`:
// src was written by other CTAs in this launch (L2 loads, not the
// read-only path).
template <typename T>
__device__ __forceinline__ void load_gram(T* dst, const T* src, int B, int ld,
                                          bool vec, bool coherent) {
  constexpr int V = vec_of<T>();
  const int tid = threadIdx.x;
  if (vec) {
    const int nch = B * B / V;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    for (int c0 = tid; c0 < nch; c0 += AP_GBATCH * DOT_THREADS) {
      uint4 u[AP_GBATCH];
#pragma unroll
      for (int j = 0; j < AP_GBATCH; ++j) {
        const int c = c0 + j * DOT_THREADS;
        if (c < nch) u[j] = coherent ? __ldcg(s4 + c) : __ldg(s4 + c);
      }
#pragma unroll
      for (int j = 0; j < AP_GBATCH; ++j) {
        const int c = c0 + j * DOT_THREADS;
        if (c < nch) {
          const int l = c * V / B;
          *reinterpret_cast<uint4*>(dst + grow<T>(l, ld) + (c * V - l * B)) = u[j];
        }
      }
    }
  } else {
    const int BB = B * B;
    for (int e0 = tid; e0 < BB; e0 += AP_GBATCH * DOT_THREADS) {
      T u[AP_GBATCH];
#pragma unroll
      for (int j = 0; j < AP_GBATCH; ++j) {
        const int e = e0 + j * DOT_THREADS;
        if (e < BB) u[j] = coherent ? __ldcg(src + e) : __ldg(src + e);
      }
#pragma unroll
      for (int j = 0; j < AP_GBATCH; ++j) {
        const int e = e0 + j * DOT_THREADS;
        if (e < BB) dst[grow<T>(e / B, ld) + e % B] = u[j];
      }
    }
  }
}

// The B x B Gram at src into dst (padded rows, as load_gram) with
// cp.async: the copies run while the CTA does other work, holding no
// registers; cp_async_wait_all() ends them (then a __syncthreads).
template <typename T>
__device__ __forceinline__ void prefetch_gram(T* dst, const T* src, int B,
                                              int ld) {
  constexpr int V = vec_of<T>();
  const int nch = B * B / V;
  for (int c = threadIdx.x; c < nch; c += DOT_THREADS) {
    const int l = c * V / B;
    const unsigned sa = (unsigned)__cvta_generic_to_shared(
        dst + grow<T>(l, ld) + (c * V - l * B));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
                 "l"(src + (size_t)c * V)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Barrier of the first 4 warps only (the exact scan's 128 threads).
__device__ __forceinline__ void bar_scan() {
  asm volatile("bar.sync 1, 128;" ::: "memory");
}

// Phase stamps of the first visit (a measurement build only, nvcc
// -DCDT_AP_STAMPS: kernel_ab.py --stamps): thread 0 of CTA g writes
// clock64() at point i to ap_stamps[g][i]; cdt_ap_stamps reads them.
constexpr int AP_NSTAMP = 8;
#ifdef CDT_AP_STAMPS
__device__ long long ap_stamps[132 * AP_NSTAMP];
#define AP_STAMP_IF(i, cond)                                         \
  if (threadIdx.x == 0 && (cond) && blockIdx.x < 132)                \
    ap_stamps[blockIdx.x * AP_NSTAMP + (i)] = clock64();
#else
#define AP_STAMP_IF(i, cond)
#endif
#define AP_STAMP(i) AP_STAMP_IF(i, t == 0)

// The exact sqrt-lasso coordinate minimizer, block_cd._sqrt_candidate in
// its expression order: with the coordinate's own contribution added back,
// s = c + a beta and rsb = ||r_back||^2 = rsqr + 2 beta c + beta^2 a; zero
// if |s| <= lam sqrt(rsb), else sign(s) (|s| - lam / sqrt(1 - lam^2 / a)
// sqrt(rsb - s^2 / a)) / a.  `lam` = lam0 lamw, `lod` = lam / sqrt(1 -
// lam^2 / a) (1 for the root when lam^2 >= a), both fixed for the scan.
// Dead columns (a <= 0) keep beta.  `rs` is ||r||^2 before the move and
// after it on return.
template <typename T>
__device__ __forceinline__ T sqrt_candidate(T bk, T ck, T a, T lam, T lod,
                                            T& rs) {
  const bool safe = a > T(0);
  const T asafe = safe ? a : T(1);
  const T sv = add_rn(ck, mul_rn(a, bk));
  const T rsb = tmax(add_rn(add_rn(rs, mul_rn(mul_rn(T(2), bk), ck)),
                            mul_rn(mul_rn(bk, bk), a)), T(0));
  const bool ok = safe && mul_rn(lam, lam) < a;
  const T inner = sqrt(tmax(add_rn(rsb, -(mul_rn(sv, sv) / asafe)), T(0)));
  const T mag = add_rn(tabs(sv), -mul_rn(lod, inner)) / asafe;
  const bool nz = ok && tabs(sv) > mul_rn(lam, sqrt(rsb));
  T val = T(0);
  if (nz) val = sv > T(0) ? mag : (sv < T(0) ? -mag : mul_rn(T(0), mag));
  if (!safe) val = bk;
  rs = tmax(add_rn(add_rn(rsb, -mul_rn(mul_rn(T(2), val), sv)),
                   mul_rn(mul_rn(val, val), a)), T(0));
  return val;
}

// CLUSTER: the cluster route (the G CTAs are one cluster; part_c, part_rs,
// part_k and kred unused), else the cooperative route.
template <typename T, int KIND, bool CLUSTER>
__global__ void __launch_bounds__(DOT_THREADS, 1)
active_pass_kernel(const T* __restrict__ X, const T* __restrict__ Xw,
                   const T* __restrict__ Kb, const T* __restrict__ lamw,
                   const long long* __restrict__ border,
                   const unsigned char* __restrict__ active,
                   const long long* __restrict__ corder,
                   const T* __restrict__ mom, const T* __restrict__ beta_in,
                   const T* __restrict__ r_in,
                   const T* __restrict__ rsqr_in, T* beta_out, T* r_out,
                   T* maxh_out, T* rsqr_out, T* part_c, T* part_rs,
                   T* part_k, T* kred, int nb, int n, int B, int rows,
                   int keep_x, int keep_r, int ista, int iters, T lam0,
                   T nsc) {
  constexpr int V = vec_of<T>();
  constexpr bool WLS = KIND == KIND_WLS, SQRT = KIND == KIND_SQRT;
  // the barrier of all G CTAs: the cluster's, or the cooperative grid's
  auto all_sync = []() {
    if constexpr (CLUSTER)
      cluster_sync();
    else
      cg::this_grid().sync();
  };
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* hdr = reinterpret_cast<int*>(smem_raw);  // [0] cursor, [1] block
  // cluster route: the visit's barrier, an mbarrier each CTA's thread g
  // arrives on in CTA g (G arrivals a phase; bytes 8-15 of the header)
  unsigned long long* xbar =
      reinterpret_cast<unsigned long long*>(smem_raw + 8);
  unsigned xph = 0;
  T* base = reinterpret_cast<T*>(smem_raw + 16);
  const bool gram = Kb != nullptr;
  const ApLayout Ly = ap_layout<T>(B, rows, keep_x, keep_r, CLUSTER, gram,
                                   gridDim.x);
  const int ld = gram_ld<T>(B);
  T* scr = base + Ly.scr;   // DOT_THREADS x V
  T* PC = base + Ly.pc;    // cluster route: this CTA's partial c's, by parity
  T* PRS = base + Ly.prs;  // ... its partial ||r||^2, by parity
  T* KS = base + Ly.ks;    // ... its slice of the summed Gram
  // ... and the mbarrier the Gram's multicast rows complete on (one
  // arrival a phase, this CTA's thread 0 expecting the B^2 elements)
  unsigned long long* gbar =
      reinterpret_cast<unsigned long long*>(PRS + vec_of<T>());
  unsigned gph = 0;
  T* Y0 = scr;              // the solve's two DOT_MAXB-long vectors, over
  T* Y1 = scr + DOT_MAXB;   // the row-group sums
  T* LD = scr + 2 * DOT_MAXB;  // the sqrt scan's lam / sqrt(1 - lam^2 / a)
  T* xs = base + Ly.xs;
  T* K = base + Ly.K;
  T* c = base + Ly.vecs;
  T* b0 = c + B;
  T* lw = b0 + B;
  T* D = lw + B;    // the block's new beta
  T* DD = D + B;    // its change
  T* Cn = DD + B;   // the exact scan's c, second buffer
  T* AS = Cn + B;   // ... its K[k, k] (0 for a dead column)
  T* TH = AS + B;   // ... its threshold n lam0 lamw[k] / K[k, k]
  T* CO = TH + B;   // ... corder
  T* red = base + Ly.red;

  const int tid = threadIdx.x, G = gridDim.x, g = blockIdx.x;
  const int lane = tid & 31, w = tid >> 5;
  const int row0 = min(g * rows, n), row1 = min(row0 + rows, n);
  const int nr = row1 - row0;
  T* rl = keep_r ? base + Ly.rs : r_out + row0;  // this CTA's rows of r
  // 16-byte paths: X's rows (and with them the kept rows, c's vectors and
  // the staggered Gram rows in shared memory) are 16-byte aligned
  const bool vec = reinterpret_cast<uintptr_t>(X) % 16 == 0 &&
                   (!WLS || reinterpret_cast<uintptr_t>(Xw) % 16 == 0) &&
                   ((size_t)B * sizeof(T)) % 16 == 0;
  const bool gvec = vec && (!gram || reinterpret_cast<uintptr_t>(Kb) % 16 == 0)
      && (gram || CLUSTER || reinterpret_cast<uintptr_t>(kred) % 16 == 0);
  // a cached Gram does not depend on a visit's sums: its copy into shared
  // memory is issued once the row sweep's loads are done, and runs under
  // the barrier; on the cluster route the CTAs copy it together as the
  // visit starts, each B / G of its rows into every CTA (bulk copies
  // multicast to the cluster), under the sweep and the barrier
  const bool pre = gram && gvec;
  const int BB = B * B;
  const int k = tid / AP_QUAD, q = tid % AP_QUAD;  // the FISTA roles
  const bool own = k < B;
  const bool lead = own && q == 0;  // writes coordinate k
  T ts = nsc * lam0;  // the threshold scale (sqrt + ista: set per visit)

  // beta_out starts as beta_in (the first barrier orders this copy before
  // CTA 0 writes any visited block); r from r_in, own rows
  for (size_t e = (size_t)g * DOT_THREADS + tid; e < (size_t)nb * B;
       e += (size_t)G * DOT_THREADS)
    beta_out[e] = beta_in[e];
  for (int i = tid; i < nr; i += DOT_THREADS) rl[i] = r_in[row0 + i];
  if (tid < B) CO[tid] = T(corder[tid]);
  if (tid == 0) {
    hdr[0] = 0;
    if (SQRT) red[AP_RS] = *rsqr_in;
    if (CLUSTER) {
      mbar_init(xbar, G);
      mbar_init(gbar, 1);
      mbar_init_fence();
    }
  }
  // cluster route: the start phase of the hardware barrier (every CTA has
  // started and initialized its mbarrier once it is complete; waited for
  // before the first arrive on another CTA's mbarrier)
  if constexpr (CLUSTER) cluster_arrive_relaxed();
  __syncthreads();
  if (w == 0) next_active_block(hdr, border, active, nb);

  T mh_all = T(0);
  int t = 0;
  AP_STAMP(0)
  for (;; ++t) {
    __syncthreads();
    const int b = hdr[1];  // (found during the previous visit's residual)
    if (b < 0) break;
    const int par = t & 1;
    T bk_pre = T(0), lw_pre = T(0);  // cluster route: beta0, lamw (tid < B)
    const T* Xb = X + (size_t)b * n * B;
    if constexpr (CLUSTER) {
      // the hardware barrier's pending phase: the start (first visit) or
      // the previous visit's "done with the partials and the Gram" (below),
      // complete by now.  It means every CTA has passed the previous
      // visit's mbarrier phases (so the arrivals below count in the next)
      // and no CTA reads its Gram any more: the next one may land
      cluster_wait();
      if (pre) {
        if (tid == 0) mbar_arrive_expect(gbar, (unsigned)(BB * sizeof(T)));
        const int l = g + G * tid;  // row l is CTA l % G's to copy
        if (l < B)
          bulk_multicast(K + grow<T>(l, ld), Kb + (size_t)b * BB + l * B,
                         (unsigned)(B * sizeof(T)), gbar,
                         (unsigned short)((1u << G) - 1));
      }
    }
    // the rows of c's (and the Gram's) left operand
    const T* Xwb = WLS ? Xw + (size_t)b * n * B : Xb;

    // 1. this CTA's partial c over its rows (kept in shared memory when
    //    planned), and without a Gram its partial Gram
    {
      partial_c<T, WLS>(
          Xwb, Xb, rl, xs, scr, row0, nr, B, keep_x, vec,
          [&] {
            if (!CLUSTER && pre) prefetch_gram(K, Kb + (size_t)b * BB, B, ld);
          },
          [&](int j, T s) {
            if constexpr (CLUSTER)
              PC[par * B + j] = s;
            else
              part_c[((size_t)par * G + g) * B + j] = s;
          });
      if (!gram) {
        // thread (row l = tid / 4, quarter) sums K[l, q + 4 j] over the
        // CTA's rows (interleaved columns: the quarters hit other banks),
        // AP_KCH columns per sweep of the rows to bound the registers
        for (int j0 = 0; j0 < DOT_MAXB / AP_QUAD; j0 += AP_KCH) {
          T kacc[AP_KCH];
#pragma unroll
          for (int j = 0; j < AP_KCH; ++j) kacc[j] = T(0);
          for (int i = 0; i < nr; ++i) {
            const T* xr = keep_x ? xs + (size_t)i * B
                                 : Xb + (size_t)(row0 + i) * B;
            const T a = !own ? T(0)
                        : WLS ? Xwb[(size_t)(row0 + i) * B + k] : xr[k];
#pragma unroll
            for (int j = 0; j < AP_KCH; ++j) {
              const int kk = q + AP_QUAD * (j0 + j);
              if (kk < B) kacc[j] += a * xr[kk];
            }
          }
          if (own) {
#pragma unroll
            for (int j = 0; j < AP_KCH; ++j) {
              const int kk = q + AP_QUAD * (j0 + j);
              if (kk < B) {
                if constexpr (CLUSTER)
                  K[grow<T>(k, ld) + kk] = kacc[j];  // read by the cluster
                else
                  part_k[(size_t)g * BB + k * B + kk] = kacc[j];
              }
            }
          }
        }
      }
    }
    AP_STAMP(1)
    if constexpr (CLUSTER) {
      // the visit's barrier, an mbarrier: thread j arrives in CTA j
      // (releasing this CTA's partials, seen through the __syncthreads),
      // thread 0 waits for the G arrivals (acquire).  beta0 and lamw of the
      // block do not depend on it: their loads are issued before it
      if (tid < B) {
        bk_pre = beta_in[(size_t)b * B + tid];
        lw_pre = lamw[(size_t)b * B + tid];
      }
      __syncthreads();
      if (tid < G) mbar_arrive_cluster(xbar, tid);
      if (tid == 0) mbar_wait_cluster(xbar, xph);
      xph ^= 1;
      __syncthreads();
    } else {
      all_sync();
    }
    AP_STAMP(2)

    // 2. without a Gram: this CTA's slice of the entries, the G partial
    //    Grams added in CTA order (each entry by a quad: CTAs q, q + 4, ...,
    //    then the quad's sums in a fixed order); the cluster route reads
    //    them out of the CTAs' K and keeps its slice in KS
    const int per = ks_per(B, G);
    if (!gram) {
      const int e0 = g * per, e1 = min(e0 + per, BB);
      for (int eb = e0; eb < e1; eb += DOT_THREADS / AP_QUAD) {
        const int e = eb + tid / AP_QUAD;
        T s = T(0);
        if (e < e1) {
          if constexpr (CLUSTER) {
            const int ke = grow<T>(e / B, ld) + e % B;
#pragma unroll 8
            for (int qq = q; qq < G; qq += AP_QUAD) s += peer(K, qq)[ke];
          } else {
#pragma unroll 8
            for (int qq = q; qq < G; qq += AP_QUAD)
              s += __ldcg(part_k + (size_t)qq * BB + e);
          }
        }
        s += __shfl_xor_sync(FULL, s, 1);
        s += __shfl_xor_sync(FULL, s, 2);
        if (e < e1 && q == 0) {
          if constexpr (CLUSTER)
            KS[e - e0] = s;
          else
            kred[e] = s;
        }
      }
      all_sync();
    }

    // 3. the block's Gram (prefetched, from kred, or from the CTAs' KS);
    //    c, the G partials added in a fixed order; beta0, lamw; the solve's
    //    vectors
    if (pre) {
      if constexpr (CLUSTER) {
        mbar_wait(gbar, gph);   // the multicast rows are in
        gph ^= 1;
      } else {
        cp_async_wait_all();
      }
    } else if (CLUSTER && !gram) {
      for (int e = tid; e < BB; e += DOT_THREADS) {
        const int o = e / per;
        K[grow<T>(e / B, ld) + e % B] = peer(KS, o)[e - o * per];
      }
    } else {
      load_gram(K, gram ? Kb + (size_t)b * BB : kred, B, ld, gvec, !gram);
    }
    // partial c of CTA gg (the cluster route: in that CTA's shared memory;
    // the sums of c are read out of scr, which Y0 and Y1 overlay)
    sum_partials<T, CLUSTER>(
        [&](int gg) -> const T* {
          if constexpr (CLUSTER)
            return peer(PC + par * B, gg);
          else
            return part_c + ((size_t)par * G + gg) * B;
        },
        G, B, vec, scr, c);
    // sqrt + ista: ||r||^2 as the previous visit left it, the G partials
    // added in the same order in every CTA
    if (SQRT && ista && t > 0 && w == 0) {
      T s = T(0);
      for (int gg = lane; gg < G; gg += 32)
        s += CLUSTER ? peer(PRS, gg)[par]
                     : __ldcg(part_rs + (size_t)par * G + gg);
      s = warp_sum(s);
      if (lane == 0) red[AP_RS] = s;
    }
    // Y0 = beta0 and Y1 = 0 past B (the FISTA product reads all DOT_MAXB)
    if (tid < DOT_MAXB) {
      const T bk = tid >= B ? T(0)
                   : CLUSTER ? bk_pre : beta_in[(size_t)b * B + tid];
      if (tid < B) {
        b0[tid] = bk;
        lw[tid] = CLUSTER ? lw_pre : lamw[(size_t)b * B + tid];
      }
      Y0[tid] = bk;
      if (tid >= B) Y1[tid] = T(0);
    }
    __syncthreads();
    AP_STAMP(3)

    // 4. the block solve, redundantly in every CTA -> D, DD, mh
    T mh = T(0);
    if (ista) {
      if (SQRT) ts = lam0 * sqrt(tmax(red[AP_RS], T(1e-30)));
      // K[4 lane + i, 8 w + c] in registers for the whole solve.  K is
      // symmetric only up to rounding: column k, as the plain twin's
      // yv @ K.
      T kc[4][8], p[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = 4 * lane + i;
        const T* row = K + grow<T>(l, ld) + 8 * w;
#pragma unroll
        for (int j0 = 0; j0 < 8; j0 += V) {
          T u[V];
          if (vec && l < B && 8 * w < B) {
            lds16(row + j0, u);
          } else {
#pragma unroll
            for (int e = 0; e < V; ++e)
              u[e] = l < B && 8 * w + j0 + e < B ? row[j0 + e] : T(0);
          }
#pragma unroll
          for (int e = 0; e < V; ++e)
            kc[i][j0 + e] = 8 * w + j0 + e < B ? u[e] : T(0);
        }
      }
      const T a = own ? K[grow<T>(k, ld) + k] : T(0);
      // Gershgorin bound L = max column abs-sum
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        p[cc] = tabs(kc[0][cc]);
#pragma unroll
        for (int i = 1; i < 4; ++i) p[cc] += tabs(kc[i][cc]);
      }
      const T colsum = warp_cols(p);
      const T L = tmax(block_max(own ? colsum : T(0), red), T(1e-30));
      const T thr = own ? ts * lw[k] / L : T(0);
      const T q0 = (own ? c[k] : T(0)) + warp_dot(Y0, kc);
      T dk = own ? b0[k] : T(0), dpk = dk;
      for (int it = 0; it < iters; ++it) {
        const T coef = mom[it + 1];  // the next step's point's coefficient
        const T* Yc = (it & 1) ? Y1 : Y0;
        T* Yn = (it & 1) ? Y0 : Y1;
        const T s = warp_dot(Yc, kc);
        if (own) {
          const T dn = soft(Yc[k] + (q0 - s) / L, thr);
          dpk = dk;
          dk = dn;
        }
        if (lead) Yn[k] = dk + coef * (dk - dpk);
        __syncthreads();
      }
      // zero-snap: exact coordinate-wise zero condition |a d + q| <= n lam0
      // lw; dead columns (a <= 0) keep beta0.  d goes to the vector the
      // last step read.
      T* Yf = (iters & 1) ? Y0 : Y1;
      if (lead) Yf[k] = dk;
      __syncthreads();
      const T s = warp_dot(Yf, kc);
      T df = T(0);
      if (own) {
        const T qk = q0 - s;
        df = dk;
        if (tabs(a * df + qk) <= ts * lw[k]) df = T(0);
        if (!(a > T(0))) df = b0[k];
      }
      if (lead) {
        D[k] = df;
        DD[k] = df - b0[k];
      }
      mh = block_max(own ? tabs(df - b0[k]) : T(0), red);
    } else if (tid < DOT_MAXB) {
      // exact sequential scan in corder via c <- c - K[kk, :] h, on the
      // first 4 warps (thread k owns coordinate k); c and beta
      // double-buffered, so each coordinate costs one 128-thread barrier
      const bool mine = tid < B;
      T *Cc = c, *Cx = Cn, *Dc = Y0, *Dx = Y1;
      T cr = T(0), dr = T(0);  // this thread's own c[k] and beta[k]
      T rs = SQRT ? red[AP_RS] : T(0);  // the running ||r||^2 (sqrt)
      if (mine) {
        const T a = K[grow<T>(tid, ld) + tid];
        const bool safe = a > T(0);
        if (SQRT) {
          // the scan's constants are a, lam = lam0 lamw and lam / den
          const T lam = mul_rn(lam0, lw[tid]);
          const bool okk = safe && mul_rn(lam, lam) < a;
          const T den =
              sqrt(okk ? add_rn(T(1), -(mul_rn(lam, lam) / a)) : T(1));
          AS[tid] = a;
          TH[tid] = lam;
          LD[tid] = lam / den;
        } else {
          AS[tid] = safe ? a : T(0);
          TH[tid] = safe ? ts * lw[tid] / a : T(0);
        }
        cr = c[tid];
        dr = b0[tid];
        Dc[tid] = dr;
      }
      bar_scan();
      // the scan's constants (AS, TH, corder) do not change in the scan:
      // the next coordinate's are read before each barrier
      int kk = (int)CO[0];
      T as = AS[kk], th = TH[kk], lo = SQRT ? LD[kk] : T(0);
      for (int i = 0; i < B; ++i) {
        const T bk = Dc[kk];
        const T ck = Cc[kk];
        const T kr = mine ? K[grow<T>(kk, ld) + tid] : T(0);
        T val;
        if (SQRT)
          val = sqrt_candidate(bk, ck, as, th, lo, rs);
        else
          val = as > T(0) ? soft(bk + ck / as, th) : bk;
        const T h = val - bk;
        if (mine) {
          cr -= kr * h;
          if (tid == kk) dr = bk + h;
          Cx[tid] = cr;
          Dx[tid] = dr;
        }
        mh = tmax(mh, tabs(h));
        const int kn = i + 1 < B ? (int)CO[i + 1] : kk;
        const T asn = AS[kn], thn = TH[kn], lon = SQRT ? LD[kn] : T(0);
        bar_scan();
        T* tc = Cc; Cc = Cx; Cx = tc;
        T* td = Dc; Dc = Dx; Dx = td;
        kk = kn;
        as = asn;
        th = thn;
        lo = lon;
      }
      if (mine) {
        D[tid] = dr;
        DD[tid] = dr - b0[tid];
      }
      if (SQRT && tid == 0) red[AP_RS] = rs;
    }
    __syncthreads();
    AP_STAMP(4)
    // cluster route: this visit's reads of the other CTAs' shared memory
    // and of its own Gram are done (their values are consumed: nothing to
    // release).  The phase is waited for as the next visit starts, or at
    // the end, by when it is complete: no CTA leaves, or overwrites
    // partials or a Gram, while another reads them, at no barrier's cost
    if constexpr (CLUSTER) cluster_arrive_relaxed();
    mh_all = tmax(mh_all, mh);
    if (g == 0 && tid < B) beta_out[(size_t)b * B + tid] = D[tid];

    // 5. r -= X_b d over this CTA's rows, one warp per row; warp 0 first
    //    finds the next visit's block, its loads under the other warps' rows
    if (w == 0) next_active_block(hdr, border, active, nb);
    T rsacc = T(0);  // sqrt + ista: this warp's share of the new ||r||^2
    update_rows(rl, xs, Xb, DD, row0, nr, B, keep_x, vec, [&](T rn) {
      if (SQRT) rsacc += rn * rn;
    });
    if (SQRT && ista) {
      // this CTA's sum of squares, for the next visit's (parity's) threshold
      const T tot = block_sum(rsacc, red);
      if (tid == 0) {
        if constexpr (CLUSTER)
          PRS[(t + 1) & 1] = tot;
        else
          part_rs[(size_t)((t + 1) & 1) * G + g] = tot;
      }
    }
    __syncthreads();
    AP_STAMP(5)
  }
  AP_STAMP_IF(6, true)
  if (keep_r)
    for (int i = tid; i < nr; i += DOT_THREADS) r_out[row0 + i] = rl[i];
  if (g == 0 && tid == 0) *maxh_out = mh_all;
  // cluster route: the last visit's partials are read (a CTA's shared
  // memory lives as long as the CTA), or with no visit the start phase
  if constexpr (CLUSTER) cluster_wait();
  // ||r||^2 out (sqrt only; ls and wls do not read it and leave it to the
  // caller): the input's for a pass with no visit; the scan's running value
  // (exact); the last visit's rebuild (ista), whose partials the other CTAs
  // wrote: one more barrier
  if constexpr (SQRT) {
    if (ista && t > 0) {
      all_sync();
      if (g == 0 && w == 0) {
        T s = T(0);
        for (int gg = lane; gg < G; gg += 32)
          s += CLUSTER ? peer(PRS, gg)[t & 1]
                       : __ldcg(part_rs + (size_t)(t & 1) * G + gg);
        s = warp_sum(s);
        if (lane == 0) *rsqr_out = s;
      }
      // ... and no CTA leaves before CTA 0 has read these
      if constexpr (CLUSTER) cluster_sync();
    } else if (g == 0 && tid == 0) {
      *rsqr_out = red[AP_RS];
    }
  }
  AP_STAMP_IF(7, true)
}

// The cluster route's kernel of `kind`.
template <typename T>
inline auto cluster_kernel(int kind) {
  return kind == KIND_WLS    ? active_pass_kernel<T, KIND_WLS, true>
         : kind == KIND_SQRT ? active_pass_kernel<T, KIND_SQRT, true>
                             : active_pass_kernel<T, KIND_LS, true>;
}

// `mom`: the momentum coefficients of iters + 1 FISTA steps (ista only;
// step it reads entry it + 1, the next step's).
template <typename T>
int active_pass(const T* X, const T* Xw, const T* Kb, const T* lamw,
                const long long* border, const unsigned char* active,
                const long long* corder, const T* mom, const T* beta_in,
                const T* r_in,
                const T* rsqr_in, T* beta_out, T* r_out, T* maxh,
                T* rsqr_out, T* part_c, T* part_rs, T* part_k, T* kred,
                int nb, int n, int B, int grid, int rows, int keep_x,
                int keep_r, int smem, int cluster, int kind, int ista,
                int iters, double lam0, double nsc, cudaStream_t s) {
  const bool gram = Kb != nullptr;
  if (B < 1 || B > DOT_MAXB || nb < 1 || n < 1 || grid < 1 || rows < 1 ||
      (long long)grid * rows < n || kind < KIND_LS || kind > KIND_SQRT ||
      !Xw || !rsqr_in || !rsqr_out || (ista && iters > 0 && !mom) ||
      (cluster ? grid > MAX_CLUSTER
               : (!part_c || !part_rs || (!gram && (!part_k || !kred)))))
    return (int)cudaErrorInvalidValue;
  if ((size_t)smem <
      ap_layout<T>(B, rows, keep_x, keep_r, cluster, gram, grid).bytes)
    return (int)cudaErrorInvalidValue;
  T tl = T(lam0), tn = T(nsc);
  if (cluster) {
    // one cluster of `grid` CTAs; a refused launch is the caller's error
    const cudaError_t e = launch_clusters(
        cluster_kernel<T>(kind), grid, DOT_THREADS, (size_t)smem, grid, s, X,
        Xw, Kb, lamw, border, active, corder, mom, beta_in, r_in, rsqr_in,
        beta_out, r_out, maxh, rsqr_out, part_c, part_rs, part_k, kred, nb, n,
        B, rows, keep_x, keep_r, ista, iters, tl, tn);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  const void* kern =
      kind == KIND_WLS ? (const void*)active_pass_kernel<T, KIND_WLS, false>
      : kind == KIND_SQRT
          ? (const void*)active_pass_kernel<T, KIND_SQRT, false>
          : (const void*)active_pass_kernel<T, KIND_LS, false>;
  void* args[] = {&X,        &Xw,     &Kb,       &lamw,   &border,
                  &active,   &corder, &mom,      &beta_in, &r_in,
                  &rsqr_in,  &beta_out, &r_out,  &maxh,   &rsqr_out,
                  &part_c,   &part_rs, &part_k,  &kred,   &nb,
                  &n,        &B,      &rows,     &keep_x, &keep_r,
                  &ista,     &iters,  &tl,       &tn};
  return (int)launch_cooperative(kern, grid, DOT_THREADS, (size_t)smem, args,
                                 s);
}

// The launch-latency probe (kernel_ab.py --small): a kernel of K1's CTA
// size and `smem` bytes of shared memory that copies the same `n16` 16-byte
// chunks at `src` into every CTA's shared memory (as every CTA of a visit
// reads the block's Gram) and then takes `barriers` barriers of the
// route's kind, launched on `grid` CTAs as each route launches K1 (the
// cooperative route with its residency query).
template <bool CLUSTER>
__global__ void __launch_bounds__(DOT_THREADS, 1)
probe_kernel(int barriers, const uint4* __restrict__ src, int n16) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint4* dst = reinterpret_cast<uint4*>(smem_raw);
  for (int i = threadIdx.x; i < n16; i += DOT_THREADS) dst[i] = __ldg(src + i);
  if (n16) __syncthreads();
  for (int i = 0; i < barriers; ++i) {
    if constexpr (CLUSTER)
      cluster_sync();
    else
      cg::this_grid().sync();
  }
}

inline int probe_launch(int cluster, int grid, int smem, int barriers,
                        const void* src, int bytes, cudaStream_t s) {
  if (bytes < 0 || bytes % 16 || bytes > smem || (bytes && !src))
    return (int)cudaErrorInvalidValue;
  const uint4* src4 = (const uint4*)src;
  int n16 = bytes / 16;
  if (!cluster) {
    void* args[] = {&barriers, &src4, &n16};
    return (int)launch_cooperative((const void*)probe_kernel<false>, grid,
                                   DOT_THREADS, (size_t)smem, args, s);
  }
  const cudaError_t e =
      launch_clusters(probe_kernel<true>, grid, DOT_THREADS, (size_t)smem,
                      grid, s, barriers, src4, n16);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace cdt

#ifdef CDT_AP_STAMPS
extern "C" int cdt_ap_stamps(void* out) {
  return (int)cudaMemcpyFromSymbol(out, cdt::ap_stamps,
                                   sizeof(cdt::ap_stamps));
}
#endif

extern "C" int cdt_probe_launch(int cluster, int grid, int smem, int barriers,
                                const void* src, int bytes, void* stream) {
  return cdt::probe_launch(cluster, grid, smem, barriers, src, bytes,
                           (cudaStream_t)stream);
}

#define CDT_ACTIVE_PASS(SUFFIX, T)                                            \
  /* the clusters of `cluster` CTAs with `smem` bytes each of the cluster  \
     route's kernel of `kind` that the device holds at once */             \
  extern "C" int cdt_active_pass_clusters_##SUFFIX(int kind, int smem,     \
                                                   int cluster,            \
                                                   void* count) {          \
    if (kind < cdt::KIND_LS || kind > cdt::KIND_SQRT || smem < 0)          \
      return (int)cudaErrorInvalidValue;                                   \
    return (int)cdt::active_clusters(                                      \
        (const void*)cdt::cluster_kernel<T>(kind), cdt::DOT_THREADS,       \
        (size_t)smem, cluster, (int*)count);                               \
  }                                                                        \
  extern "C" int cdt_active_pass_##SUFFIX(                                    \
      const void* X, const void* Xw, const void* Kb, const void* lamw,        \
      const void* border, const void* active, const void* corder,             \
      const void* mom, const void* beta_in, const void* r_in,                 \
      const void* rsqr_in,                                                    \
      void* beta_out, void* r_out, void* maxh, void* rsqr_out, void* part_c,  \
      void* part_rs, void* part_k, void* kred, int nb, int n, int B,          \
      int grid, int rows, int keep_x, int keep_r, int smem, int cluster,      \
      int kind, int ista, int iters, double lam0, double nsc, void* stream) { \
    return cdt::active_pass<T>(                                               \
        (const T*)X, (const T*)Xw, (const T*)Kb, (const T*)lamw,              \
        (const long long*)border, (const unsigned char*)active,               \
        (const long long*)corder, (const T*)mom, (const T*)beta_in,           \
        (const T*)r_in,                                                       \
        (const T*)rsqr_in, (T*)beta_out, (T*)r_out, (T*)maxh, (T*)rsqr_out,   \
        (T*)part_c, (T*)part_rs, (T*)part_k, (T*)kred, nb, n, B, grid, rows,  \
        keep_x, keep_r, smem, cluster, kind, ista, iters, lam0, nsc,          \
        (cudaStream_t)stream);                                                \
  }

CDT_ACTIVE_PASS(f32, float)
CDT_ACTIVE_PASS(f64, double)
