// Fused KKT full check, phases A (K3) and B (K4): least-squares kind, f32.
//
// Replace coordinatedescent_jl_tpu/ops/pallas_check.py:check_phase_a and
// :check_phase_b.  They evaluate, elementwise over the (nb, B) blocked
// coordinates, the same formulas as the plain cores of
// ops/block_cd.py (_gap_safe_core, _stale_core_ls, _habs_reduce_core,
// _ls_candidate), in the same operation order; this file is compiled with
// -fmad=false so no multiply-add is contracted and each operation rounds
// as PyTorch's separate elementwise kernels do.
//
// Design: one cooperative launch per call (cudaLaunchCooperativeKernel) of
// a co-resident grid of G CTAs of 256 threads, G from
// kernels/check.py::plan_check (one CTA per 8 block rows, capped at the
// CTAs the card holds at once).  A warp owns a block row, rows strided
// over the G x 8 warps; per 128-wide chunk of the row each lane takes 4
// consecutive coordinates with one 16-byte load per array
// (common.cuh::load_chunk; masked scalar loads when B % 4 != 0 or an
// array is misaligned).
//   - Phase A with the screen: the screen's global terms (the max ratio,
//     the L1 norm of beta, the all-penalized flag) are the one grid-wide
//     dependency before any row can decide `screened`.  Each CTA writes
//     its three partials, the CTAs meet at a grid barrier (cooperative
//     groups' grid.sync()), then every CTA adds the G partials itself in
//     one fixed order: no atomics, the same scale and rho in every CTA
//     and on every run.  When every warp owns at most one row of one chunk
//     (B <= 128, nb <= 8 G: the bench's 782 rows on 98 CTAs), the row's
//     inputs stay in registers from the screen's pass to the row pass;
//     otherwise the row pass reads them again (from L2).
//   - The row pass: the steps, the drift-ball bound and certification and
//     (phase A) the screen per coordinate, warp votes for the row's
//     masks, written by the row's warp; phase B re-evaluates the steps
//     with the refreshed c against phase A's bound and masks.
//   - maxh: each CTA's max, a grid barrier, then CTA 0 takes the max of
//     the G values.  A barrier rather than a last-arriving-CTA
//     counter: the counter needs zeroed state kept between launches and
//     reset by the kernel, the barrier needs none.  Phase B and phase A
//     without the screen have no other grid-wide dependency and take the
//     same cooperative launch, with this one barrier.
// The scalars [lam0, n, ||r||^2, r'y, tol] are read from a device row and
// nothing is read back, so the check needs no host round trip.
//
// What bounds it on an H100: latency, not bytes.  At p = 100K a call reads
// ~2.8 MB (0.8 us at 3.35 TB/s); its time is one launch, one or two grid
// barriers (~1-2 us each at ~100 CTAs), one round of 16-byte loads and the
// reductions.  The design spreads the rows over ~100 SMs so that the load
// round is short, and keeps the barriers to the true dependencies.
#include <cooperative_groups.h>

#include <cfloat>
#include <cstdint>
#include <initializer_list>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace cdt {

constexpr int CK_THREADS = 256;
constexpr int CK_WARPS = CK_THREADS / 32;  // block rows a CTA owns at once
constexpr int CK_V = 4;                    // coordinates a lane loads at once
constexpr int CK_CHUNK = 32 * CK_V;        // coordinates a warp loads at once
constexpr int CK_PART = 4;  // per-CTA partials: max ratio, L1, bad, maxh
constexpr int CK_UNROLL = 4;  // partials a lane loads at once, per field

struct CheckArgs {
  const float* c;         // phase A: the cached c; phase B: the refreshed c
  const float* beta;
  const float* drift;     // phase A: (nb,)
  const float* bound_in;  // phase B: phase A's bound, ub and cand
  const float* ubf;
  const float* candf;
  const float* adiag;
  const float* lamw;
  const float* validf;
  const float* xwnorm;
  const float* scal;      // [lam0, n, ||r||^2, r'y, tol]
  float* need;            // phase A: (nb,) masks and the (nb, B) bound
  float* ub;
  float* cand;
  float* bound;
  float* maxh;            // 1 value
  float* active;          // (nb,)
  float* part;            // CK_PART x G partials
  int nb, B, screen, vec;
};

struct Scalars {
  float lam0, nsc, rn2, ry, tol, lamscale, srn2, slack;
};

__device__ __forceinline__ Scalars read_scalars(const float* scal) {
  Scalars s;
  s.lam0 = __ldg(scal);
  s.nsc = __ldg(scal + 1);
  s.rn2 = __ldg(scal + 2);
  s.ry = __ldg(scal + 3);
  s.tol = __ldg(scal + 4);
  s.lamscale = s.nsc * s.lam0;
  s.srn2 = sqrtf(s.rn2);
  s.slack = 8.f * sqrtf(s.nsc) * FLT_EPSILON;
  return s;
}

// One lane's CK_V coordinates of a row: the inputs every phase reads.
struct Chunk {
  float c[CK_V], bt[CK_V], a[CK_V], lw[CK_V], vf[CK_V], xw[CK_V];
};

__device__ __forceinline__ void load_row(const CheckArgs& A, int b, int k0,
                                         Chunk& v) {
  const size_t off = (size_t)b * A.B;
  const bool vec = A.vec;
  load_chunk(A.c + off, k0, A.B, vec, v.c);
  load_chunk(A.beta + off, k0, A.B, vec, v.bt);
  load_chunk(A.adiag + off, k0, A.B, vec, v.a);
  load_chunk(A.lamw + off, k0, A.B, vec, v.lw);
  load_chunk(A.validf + off, k0, A.B, vec, v.vf);
  load_chunk(A.xwnorm + off, k0, A.B, vec, v.xw);
}

__device__ __forceinline__ void store_chunk(float* row, int k0, int width,
                                            bool vec,
                                            const float (&v)[CK_V]) {
  if (vec && k0 < width) {
    *reinterpret_cast<float4*>(row + k0) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < CK_V; ++e)
      if (k0 + e < width) row[k0 + e] = v[e];
  }
}

__device__ __forceinline__ float ls_candidate(float beta, float c, float a,
                                              float lamscale, float lw) {
  const bool safe = a > 0.f;
  const float as = safe ? a : 1.f;
  const float val = soft(beta + c / as, lamscale * lw / as);
  return safe ? val : beta;
}

__device__ __forceinline__ float habs_floor(float habs, float beta,
                                            float xw, float rn2, float eps) {
  const float sn = 4.f * eps * sqrtf(rn2) / tmax(xw, 1e-30f);
  const float floor = 2.f * eps * tabs(beta) + sn;
  return habs <= floor ? 0.f : habs;
}

// The screen's global terms over one chunk (`dr` the row's drift).
__device__ __forceinline__ void screen_terms(const Chunk& v, float dr, int k0,
                                             int B, const Scalars& s,
                                             float& rmax, float& l1,
                                             float& bad) {
#pragma unroll
  for (int e = 0; e < CK_V; ++e) {
    if (k0 + e >= B) continue;
    const float xnorm = sqrtf(tmax(v.a[e], 0.f));
    const float u = tabs(v.c[e]) + xnorm * dr + xnorm * s.srn2 * s.slack;
    const float lamvec = s.lamscale * v.lw[e];
    const bool valid = v.vf[e] > 0.f;
    const bool pos = valid && lamvec > 0.f;
    rmax = tmax(rmax, pos ? u / lamvec : 0.f);
    if (valid && !(lamvec > 0.f)) bad = 1.f;
    l1 += valid ? v.lw[e] * tabs(v.bt[e]) : 0.f;
  }
}

// The potential steps h of one chunk (0 where invalid).
__device__ __forceinline__ void steps(const Chunk& v, const Scalars& s,
                                      float (&h)[CK_V]) {
#pragma unroll
  for (int e = 0; e < CK_V; ++e) {
    const bool valid = v.vf[e] > 0.f;
    h[e] = valid ? ls_candidate(v.bt[e], v.c[e], v.a[e], s.lamscale, v.lw[e])
                       - v.bt[e]
                 : 0.f;
  }
}

// The drift-ball bounds |h| + ||Xw_j|| dball / a of one chunk.
__device__ __forceinline__ void bounds(const Chunk& v, const float (&h)[CK_V],
                                       float dball, float (&bnd)[CK_V]) {
#pragma unroll
  for (int e = 0; e < CK_V; ++e) {
    const float as = v.a[e] > 0.f ? v.a[e] : 1.f;
    bnd[e] = v.vf[e] > 0.f ? tabs(h[e]) + v.xw[e] * dball / as : 0.f;
  }
}

// _habs_reduce_core over one chunk: bound substitution, screened-row
// zeroing, the noise floor, then the running maxh and activation.
__device__ __forceinline__ void reduce_chunk(const Chunk& v,
                                             const float (&h)[CK_V],
                                             const float (&bnd)[CK_V],
                                             bool ubb, bool cnd, int k0,
                                             int B, const Scalars& s,
                                             float& lmax, bool& act) {
#pragma unroll
  for (int e = 0; e < CK_V; ++e) {
    if (k0 + e >= B) continue;
    float habs = ubb ? bnd[e] : tabs(h[e]);
    habs = cnd ? habs : 0.f;
    habs = habs_floor(habs, v.bt[e], v.xw[e], s.rn2, FLT_EPSILON);
    lmax = tmax(lmax, habs);
    act = act || habs >= s.tol || v.bt[e] != 0.f;
  }
}

// Phase A's pass over row b.  `kept` is the row's only chunk when the warp
// holds it in registers (else nullptr: each chunk is loaded here, and a
// row of several chunks is loaded again for the second half).
__device__ __forceinline__ void row_a(const CheckArgs& A, const Scalars& s,
                                      int b, int lane, const Chunk* kept,
                                      float scale, float rho, bool ok,
                                      float& lmax) {
  const float eps = FLT_EPSILON;
  const int B = A.B;
  const int nch = (B + CK_CHUNK - 1) / CK_CHUNK;
  const size_t off = (size_t)b * B;
  const float dr = __ldg(A.drift + b);
  const float dball = dr * (1.f + 64.f * eps);
  Chunk v;
  float h[CK_V], bnd[CK_V];
  bool candb = !A.screen, certb = true;
  for (int j = 0; j < nch; ++j) {
    const int k0 = j * CK_CHUNK + lane * CK_V;
    if (kept)
      v = *kept;
    else
      load_row(A, b, k0, v);
    steps(v, s, h);
    bounds(v, h, dball, bnd);
    store_chunk(A.bound + off, k0, B, A.vec, bnd);
#pragma unroll
    for (int e = 0; e < CK_V; ++e) {
      if (k0 + e >= B) continue;
      certb = certb && (bnd[e] < s.tol);
      if (A.screen) {
        const bool valid = v.vf[e] > 0.f;
        const float xnorm = sqrtf(tmax(v.a[e], 0.f));
        const float u = tabs(v.c[e]) + xnorm * dr + xnorm * s.srn2 * s.slack;
        const float lamvec = s.lamscale * v.lw[e];
        const bool pos = valid && lamvec > 0.f;
        const bool screened =
            ok && pos && v.bt[e] == 0.f
            && (scale * u + rho * xnorm < lamvec * (1.f - 8.f * eps));
        candb = candb || (valid && !screened);
      }
    }
  }
  const bool cnd = __any_sync(FULL, candb);
  const bool cert = __all_sync(FULL, certb);
  const bool stale = dr > 0.f;
  const bool ubb = stale && cert;
  bool act = false;
  for (int j = 0; j < nch; ++j) {
    const int k0 = j * CK_CHUNK + lane * CK_V;
    if (nch > 1) {  // one chunk: v, h and bnd are still the row's
      load_row(A, b, k0, v);
      steps(v, s, h);
      bounds(v, h, dball, bnd);
    }
    reduce_chunk(v, h, bnd, ubb, cnd, k0, B, s, lmax, act);
  }
  act = __any_sync(FULL, act);
  if (lane == 0) {
    A.need[b] = (cnd && stale && !cert) ? 1.f : 0.f;
    A.ub[b] = ubb ? 1.f : 0.f;
    A.cand[b] = cnd ? 1.f : 0.f;
    A.active[b] = act ? 1.f : 0.f;
  }
}

// Phase B's pass over row b: the steps with the refreshed c.
__device__ __forceinline__ void row_b(const CheckArgs& A, const Scalars& s,
                                      int b, int lane, float& lmax) {
  const int B = A.B;
  const int nch = (B + CK_CHUNK - 1) / CK_CHUNK;
  const size_t off = (size_t)b * B;
  const bool ubb = __ldg(A.ubf + b) > 0.f, cnd = __ldg(A.candf + b) > 0.f;
  bool act = false;
  for (int j = 0; j < nch; ++j) {
    const int k0 = j * CK_CHUNK + lane * CK_V;
    Chunk v;
    float h[CK_V], bnd[CK_V];
    load_row(A, b, k0, v);
    load_chunk(A.bound_in + off, k0, B, (bool)A.vec, bnd);
    steps(v, s, h);
    reduce_chunk(v, h, bnd, ubb, cnd, k0, B, s, lmax, act);
  }
  act = __any_sync(FULL, act);
  if (lane == 0) A.active[b] = act ? 1.f : 0.f;
}

// The CTA's max of `lmax` into its partial, a grid barrier, then CTA 0
// writes the max of the G partials to maxh.
__device__ __forceinline__ void finish_maxh(const CheckArgs& A,
                                            cg::grid_group& grid,
                                            float (*red)[CK_WARPS],
                                            float lmax) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  lmax = warp_max(lmax);
  if (lane == 0) red[3][w] = lmax;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = red[3][0];
    for (int q = 1; q < CK_WARPS; ++q) m = tmax(m, red[3][q]);
    A.part[(size_t)blockIdx.x * CK_PART + 3] = m;
  }
  grid.sync();
  if (blockIdx.x == 0 && w == 0) {
    float m = 0.f;
    for (int q0 = lane; q0 < (int)gridDim.x; q0 += 32 * CK_UNROLL) {
      float pm[CK_UNROLL];
#pragma unroll
      for (int u = 0; u < CK_UNROLL; ++u) {
        const int q = q0 + 32 * u;
        pm[u] = q < (int)gridDim.x ? __ldcg(A.part + (size_t)q * CK_PART + 3)
                                   : 0.f;
      }
#pragma unroll
      for (int u = 0; u < CK_UNROLL; ++u) m = tmax(m, pm[u]);
    }
    m = warp_max(m);
    if (lane == 0) *A.maxh = m;
  }
}

__global__ void __launch_bounds__(CK_THREADS) check_a_kernel(CheckArgs A) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float red[CK_PART][CK_WARPS];
  const float eps = FLT_EPSILON;
  const Scalars s = read_scalars(A.scal);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int gw = blockIdx.x * CK_WARPS + w;
  const int nwg = gridDim.x * CK_WARPS;
  // every warp owns at most one row of one chunk: keep it in registers
  const bool keep = A.nb <= nwg && A.B <= CK_CHUNK;
  Chunk v;
  if (keep && gw < A.nb) load_row(A, gw, lane * CK_V, v);

  float scale = 1.f, rho = 0.f;
  bool ok = false;
  if (A.screen) {
    float rmax = 0.f, l1 = 0.f, bad = 0.f;
    if (keep) {
      if (gw < A.nb)
        screen_terms(v, __ldg(A.drift + gw), lane * CK_V, A.B, s, rmax, l1,
                     bad);
    } else {
      for (int b = gw; b < A.nb; b += nwg) {
        const float dr = __ldg(A.drift + b);
        for (int k0 = lane * CK_V; k0 < A.B; k0 += CK_CHUNK) {
          Chunk t;
          load_row(A, b, k0, t);
          screen_terms(t, dr, k0, A.B, s, rmax, l1, bad);
        }
      }
    }
    rmax = warp_max(rmax);
    l1 = warp_sum(l1);
    bad = warp_max(bad);
    if (lane == 0) {
      red[0][w] = rmax;
      red[1][w] = l1;
      red[2][w] = bad;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float r0 = red[0][0], r1 = red[1][0], r2 = red[2][0];
      for (int q = 1; q < CK_WARPS; ++q) {
        r0 = tmax(r0, red[0][q]);
        r1 += red[1][q];
        r2 = tmax(r2, red[2][q]);
      }
      float* p = A.part + (size_t)blockIdx.x * CK_PART;
      p[0] = r0;
      p[1] = r1;
      p[2] = r2;
    }
    grid.sync();
    // every warp of every CTA adds the G partials the same way: lane q
    // takes CTAs q, q + 32, ... in order (their loads in flight together:
    // one L2 round for G <= 32 CK_UNROLL), then a fixed shuffle tree (its
    // sums are commutative pairs, so every lane holds the same value)
    float ratio = 0.f, gl1 = 0.f, gbad = 0.f;
    for (int q0 = lane; q0 < (int)gridDim.x; q0 += 32 * CK_UNROLL) {
      float pr[CK_UNROLL], pl[CK_UNROLL], pb[CK_UNROLL];
#pragma unroll
      for (int u = 0; u < CK_UNROLL; ++u) {
        const int q = q0 + 32 * u;
        const float* p = A.part + (size_t)q * CK_PART;
        const bool in = q < (int)gridDim.x;
        pr[u] = in ? __ldcg(p) : 0.f;
        pl[u] = in ? __ldcg(p + 1) : 0.f;
        pb[u] = in ? __ldcg(p + 2) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < CK_UNROLL; ++u) {
        ratio = tmax(ratio, pr[u]);
        gl1 += pl[u];
        gbad = tmax(gbad, pb[u]);
      }
    }
    ratio = warp_max(ratio);
    gl1 = warp_sum(gl1);
    ok = warp_max(gbad) == 0.f;
    scale = fminf(1.f, 1.f / tmax(ratio, 1e-30f));
    const float primal = s.rn2 / (2.f * s.nsc) + s.lam0 * gl1;
    const float dual =
        (2.f * scale * s.ry - scale * scale * s.rn2) / (2.f * s.nsc);
    const float gap = tmax(primal - dual, 0.f)
                      + 64.f * eps * (tabs(primal) + tabs(dual));
    rho = sqrtf(2.f * s.nsc * gap);
  }

  float lmax = 0.f;
  if (keep) {
    if (gw < A.nb) row_a(A, s, gw, lane, &v, scale, rho, ok, lmax);
  } else {
    for (int b = gw; b < A.nb; b += nwg)
      row_a(A, s, b, lane, nullptr, scale, rho, ok, lmax);
  }
  finish_maxh(A, grid, red, lmax);
}

__global__ void __launch_bounds__(CK_THREADS) check_b_kernel(CheckArgs A) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float red[CK_PART][CK_WARPS];
  const Scalars s = read_scalars(A.scal);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nwg = gridDim.x * CK_WARPS;
  float lmax = 0.f;
  for (int b = blockIdx.x * CK_WARPS + w; b < A.nb; b += nwg)
    row_b(A, s, b, lane, lmax);
  finish_maxh(A, grid, red, lmax);
}

inline const void* check_kernel(int phase_b) {
  return phase_b ? (const void*)check_b_kernel : (const void*)check_a_kernel;
}

inline bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

int launch_check(int phase_b, CheckArgs a, int grid, cudaStream_t st) {
  if (a.nb < 1 || a.B < 1 || grid < 1 || a.part == nullptr)
    return (int)cudaErrorInvalidValue;
  // 16-byte loads (and bound stores) need every row to start on 16 bytes
  a.vec = a.B % CK_V == 0;
  for (const void* p : {(const void*)a.c, (const void*)a.beta,
                        (const void*)a.adiag, (const void*)a.lamw,
                        (const void*)a.validf, (const void*)a.xwnorm,
                        phase_b ? (const void*)a.bound_in
                                : (const void*)a.bound})
    a.vec = a.vec && aligned16(p);
  // the grid must be co-resident (a plain launch of too large a grid
  // would hang at the barrier; the cooperative launch refuses it)
  const void* kern = check_kernel(phase_b);
  int resident = 0;
  cudaError_t e = resident_ctas(kern, CK_THREADS, 0, &resident);
  if (e != cudaSuccess) return (int)e;
  if (resident < grid) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(kern, dim3(grid), dim3(CK_THREADS), args, 0,
                                  st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace cdt

// The co-resident CTAs of phase A's (phase_b = 0) or phase B's kernel on
// the current device, into *ctas (the launch planner's input).
extern "C" int cdt_check_resident_f32(int phase_b, void* ctas) {
  return (int)cdt::resident_ctas(cdt::check_kernel(phase_b), cdt::CK_THREADS,
                                 0, (int*)ctas);
}

extern "C" int cdt_check_a_f32(const void* c, const void* beta,
                               const void* drift, const void* adiag,
                               const void* lamw, const void* validf,
                               const void* xwnorm, const void* scal,
                               void* need, void* ub, void* cand, void* bound,
                               void* maxh, void* active, void* part, int nb,
                               int B, int screen, int grid, void* stream) {
  cdt::CheckArgs a{};
  a.c = (const float*)c;
  a.beta = (const float*)beta;
  a.drift = (const float*)drift;
  a.adiag = (const float*)adiag;
  a.lamw = (const float*)lamw;
  a.validf = (const float*)validf;
  a.xwnorm = (const float*)xwnorm;
  a.scal = (const float*)scal;
  a.need = (float*)need;
  a.ub = (float*)ub;
  a.cand = (float*)cand;
  a.bound = (float*)bound;
  a.maxh = (float*)maxh;
  a.active = (float*)active;
  a.part = (float*)part;
  a.nb = nb;
  a.B = B;
  a.screen = screen;
  return cdt::launch_check(0, a, grid, (cudaStream_t)stream);
}

extern "C" int cdt_check_b_f32(const void* c, const void* beta,
                               const void* bound, const void* ubf,
                               const void* candf, const void* adiag,
                               const void* lamw, const void* validf,
                               const void* xwnorm, const void* scal,
                               void* maxh, void* active, void* part, int nb,
                               int B, int grid, void* stream) {
  cdt::CheckArgs a{};
  a.c = (const float*)c;
  a.beta = (const float*)beta;
  a.bound_in = (const float*)bound;
  a.ubf = (const float*)ubf;
  a.candf = (const float*)candf;
  a.adiag = (const float*)adiag;
  a.lamw = (const float*)lamw;
  a.validf = (const float*)validf;
  a.xwnorm = (const float*)xwnorm;
  a.scal = (const float*)scal;
  a.maxh = (float*)maxh;
  a.active = (float*)active;
  a.part = (float*)part;
  a.nb = nb;
  a.B = B;
  return cdt::launch_check(1, a, grid, (cudaStream_t)stream);
}
