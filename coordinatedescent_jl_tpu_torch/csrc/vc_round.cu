// The varying-coefficient grid's refine round, float and double, in one
// launch.
//
// Replaces no Pallas kernel: the JAX package's batched grid and batched
// LOO-CV (coordinatedescent_jl_tpu/models/varying_coefficient.py) run their
// rounds as XLA programs, whose plain PyTorch counterpart,
// models/varying_coefficient.py::_VcBatchOps.round_plain, is ~430 small
// eager operations a round at n = 500, p = 50, degree 1, 16 steps.  This
// kernel computes the same round with the same arithmetic.  Lane l's
// expanded column (j, d) is X_j * dpow[l, :, d], with the lane's
// preconditioner sc, Lipschitz bound Lt and thresholds thrw.  From
// zt = vt = B sc, iters steps (none for a certified lane, whose zt stays
// B sc) of
//     u = vt / sc,  r = y - sum_d dpow_d (X u_d),
//     gv_(j,d) = sum_i X_ij ((w_i r_i) dpow_id) / sc_(j,d),
//     z = soft(vt + gv / Lt, thrw / sc / Lt),
//     vt = z + coef_t (z - zt),  zt = z,
// with the momentum coefficients coef_t the host computed in the working
// dtype; then B = zt / sc, the fresh residual R = y - sum_d dpow_d (X B_d),
// the KKT certificate
//     c = X'((w R) dpow) / adiag,  t = thrw / adiag,  zq = B + c,
//     H = |zq| > t ? |c - t sign(zq)| : |B|,
// zeroed at float32 where H <= 2 eps |B| + 4 eps ||R|| / xwnorm, its max mx
// (NaN where any H is), and the stall escape:
//     stall = cert ? stall : (mx < best ? 0 : stall + 1),
//     best = min(best, mx),  ok = stall >= patience && mx < 4 tol && mx finite,
//     esc |= !cert && ok && !(mx < tol),  cert |= mx < tol || ok.
//
// Design: one CTA of 512 threads a lane, so the launch has no grid barrier
// and takes any number of lanes (the cell's chunks of 128 and 94 lanes on
// 132 SMs: one wave).  The lane's step vectors (zt, vt, sc, the thresholds,
// u) and the transposed product's partial sums live in shared memory for
// the whole round.  Route 0: X (its rows at an odd stride, so the pass over
// rows reads distinct banks) and the lane's w, y, dpow and weighted
// residual (w r) dpow in shared memory too, read from global memory once a
// round; route 1, where those do not fit beside the step vectors: X and the
// lane's rows read through the read-only path from L2 (every CTA reads the
// one X), the weighted residual in a global scratch of n q1 a lane.  A step
// is two passes over X: the prediction, a thread a row with q1
// accumulators over the p columns, and the transposed product, thread
// (g, j) summing rows g, g + G, ... of column j, the G partials added in
// order of g; three barriers a step.  Every sum is in a fixed order:
// deterministic, no atomics.  The two products are FP32 or FP64 FMA chains
// in another order than cuBLAS's; the elementwise formulas round each
// operation as PyTorch's separate kernels do (mul_rn, add_rn, IEEE
// division and square root).  Results match the twin to rounding, and a
// certified lane's B, (B sc) / sc, bit for bit.
//
// What bounds it on an H100: the chain of dependent steps.  A round is
// 4 (iters + 1) n p q1 flops a lane (k = 128 lanes at the cell's shape:
// 0.44 GFLOP, 6.5 us at the 67 TFLOP/s f32 peak) over an X of n p
// sizeof(T) bytes (100 KB) that stays in L2; each step is two dependent
// passes and three barriers.  One launch a round instead of one per
// operation takes the host's dispatch off that chain.
#include <cfloat>

#include "common.cuh"

namespace cdt {

constexpr int VC_THREADS = 512;
constexpr int VC_Q = 4;  // powers a thread accumulates at once

// Row groups of the transposed product: G groups of p column threads
// (one group from 512 columns on, each thread then several columns).
__host__ __device__ inline int vc_groups(int n, int p) {
  return p >= VC_THREADS ? 1 : (VC_THREADS / p < n ? VC_THREADS / p : n);
}

// Shared-memory layout, in elements of T; every array starts 16-byte
// aligned.  kernels/vc_round.py::smem_bytes computes the same bytes.
struct VcLayout {
  size_t x, w, y, dp, t, zt, vt, sc, thl, u, part, red, bytes;
  int ps;  // X's row stride in shared memory
};

template <typename T>
__host__ __device__ inline size_t vc_up(size_t m) {
  const size_t V = 16 / sizeof(T);
  return (m + V - 1) / V * V;
}

template <typename T>
__host__ __device__ inline VcLayout vc_layout(int n, int p, int q1,
                                              int route) {
  VcLayout L;
  const size_t ep = (size_t)p * q1, rows = route == 0 ? (size_t)n : 0;
  size_t o = 0;
  L.ps = p | 1;
  L.x = o;    o += vc_up<T>(rows * L.ps);   // route 0: X
  L.w = o;    o += vc_up<T>(rows);          // the lane's weights
  L.y = o;    o += vc_up<T>(rows);          // the response
  L.dp = o;   o += vc_up<T>(rows * q1);     // the lane's powers
  L.t = o;    o += vc_up<T>(rows * q1);     // (w r) dpow
  L.zt = o;   o += vc_up<T>(ep);
  L.vt = o;   o += vc_up<T>(ep);
  L.sc = o;   o += vc_up<T>(ep);
  L.thl = o;  o += vc_up<T>(ep);            // thrw / sc / Lt
  L.u = o;    o += vc_up<T>(ep);            // vt / sc, then B
  L.part = o; o += vc_up<T>((size_t)vc_groups(n, p) * ep);
  L.red = o;  o += 32;                      // block reductions' slots
  L.bytes = sizeof(T) * o;
  return L;
}

// A read-only element: through the read-only path from L2 on route 1.
template <int ROUTE, typename T>
__device__ __forceinline__ T vc_ld(const T* p) {
  if constexpr (ROUTE == 1)
    return __ldg(p);
  else
    return *p;
}

template <typename T>
__device__ __forceinline__ T qnan() {
  if constexpr (sizeof(T) == 4)
    return __int_as_float(0x7fc00000);
  else
    return __longlong_as_double(0x7ff8000000000000LL);
}

template <typename T>
__device__ __forceinline__ T tsign(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : x);
}

// Whether power e of the chunk from d0 exists (q1 = QN when QN > 0).
template <int QN>
__device__ __forceinline__ bool vc_has(int d0, int e, int q1) {
  if constexpr (QN > 0)
    return e < QN;
  else
    return d0 + e < q1;
}

// The prediction pass: for each row i of this thread (i = tid, tid + 512,
// ...), r = y_i - sum_d (sum_j X_ij u[j q1 + d]) dpow_id (the products
// summed over d in order), and t[i q1 + d] = (w_i r) dpow_id.  With Rl, r
// is also stored there; returns the thread's sum of r^2 (0 without Rl).
template <typename T, int ROUTE, int QN>
__device__ __forceinline__ T vc_predict(const T* xs, int ps, int n, int p,
                                        int q1, const T* u, const T* wv,
                                        const T* yv, const T* dv, T* tv,
                                        T* Rl) {
  T rr = T(0);
  for (int i = threadIdx.x; i < n; i += VC_THREADS) {
    const T* xr = xs + (size_t)i * ps;
    const T* di = dv + (size_t)i * q1;
    T pred = T(0);
    for (int d0 = 0; d0 < q1; d0 += VC_Q) {
      T acc[VC_Q];
#pragma unroll
      for (int e = 0; e < VC_Q; ++e) acc[e] = T(0);
#pragma unroll 4
      for (int j = 0; j < p; ++j) {
        const T x = vc_ld<ROUTE>(xr + j);
        const T* uj = u + (size_t)j * q1 + d0;
#pragma unroll
        for (int e = 0; e < VC_Q; ++e)
          if (vc_has<QN>(d0, e, q1)) acc[e] += x * uj[e];
      }
#pragma unroll
      for (int e = 0; e < VC_Q; ++e)
        if (vc_has<QN>(d0, e, q1)) {
          const T pr = mul_rn(acc[e], vc_ld<ROUTE>(di + d0 + e));
          pred = d0 + e == 0 ? pr : add_rn(pred, pr);
        }
    }
    const T r = add_rn(vc_ld<ROUTE>(yv + i), -pred);
    const T wr = mul_rn(vc_ld<ROUTE>(wv + i), r);
    for (int d = 0; d < q1; ++d)
      tv[(size_t)i * q1 + d] = mul_rn(wr, vc_ld<ROUTE>(di + d));
    if (Rl) {
      Rl[i] = r;
      rr = add_rn(rr, mul_rn(r, r));
    }
  }
  return rr;
}

// The transposed pass: part[g ep + j q1 + d] = sum over rows i = g, g + G,
// ... of X_ij t[i q1 + d], thread (g, j) for each of the G x p pairs.
template <typename T, int ROUTE, int QN>
__device__ __forceinline__ void vc_transposed(const T* xs, int ps, int n,
                                              int p, int q1, int G,
                                              const T* tv, T* part) {
  const int ep = p * q1;
  for (int gj = threadIdx.x; gj < G * p; gj += VC_THREADS) {
    const int g = gj / p, j = gj - g * p;
    for (int d0 = 0; d0 < q1; d0 += VC_Q) {
      T acc[VC_Q];
#pragma unroll
      for (int e = 0; e < VC_Q; ++e) acc[e] = T(0);
#pragma unroll 4
      for (int i = g; i < n; i += G) {
        const T x = vc_ld<ROUTE>(xs + (size_t)i * ps + j);
        const T* ti = tv + (size_t)i * q1 + d0;
#pragma unroll
        for (int e = 0; e < VC_Q; ++e)
          if (vc_has<QN>(d0, e, q1)) acc[e] += x * ti[e];
      }
#pragma unroll
      for (int e = 0; e < VC_Q; ++e)
        if (vc_has<QN>(d0, e, q1))
          part[(size_t)g * ep + (size_t)j * q1 + d0 + e] = acc[e];
    }
  }
}

// The G partials of coordinate c, added in order of g.
template <typename T>
__device__ __forceinline__ T vc_gather(const T* part, int G, int ep, int c) {
  T s = part[c];
  for (int g = 1; g < G; ++g) s += part[(size_t)g * ep + c];
  return s;
}

template <typename T, int ROUTE, int QN>
__global__ void __launch_bounds__(VC_THREADS, 1) vc_round_kernel(
    const T* __restrict__ X, const T* __restrict__ y,
    const T* __restrict__ w, const T* __restrict__ dpow,
    const T* __restrict__ sc, const T* __restrict__ Lt,
    const T* __restrict__ adiag, const T* __restrict__ xwnorm,
    const T* __restrict__ thrw, const T* __restrict__ B,
    const unsigned char* __restrict__ cert, const T* __restrict__ best,
    const int* __restrict__ stall, const unsigned char* __restrict__ esc,
    const T* __restrict__ mom, T* __restrict__ scratch, T* __restrict__ Bo,
    T* __restrict__ R, T* __restrict__ mx, unsigned char* __restrict__ cert_o,
    T* __restrict__ best_o, int* __restrict__ stall_o,
    unsigned char* __restrict__ esc_o, int n, int p, int q1_in, int iters,
    int patience, T tol, T tol4) {
  const int q1 = QN > 0 ? QN : q1_in;
  const int ep = p * q1;
  const int tid = threadIdx.x, l = blockIdx.x;
  const int G = vc_groups(n, p);
  const size_t le = (size_t)l * ep, ln = (size_t)l * n * q1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const VcLayout Ly = vc_layout<T>(n, p, q1, ROUTE);
  T *zt = sm + Ly.zt, *vt = sm + Ly.vt, *scv = sm + Ly.sc, *thl = sm + Ly.thl;
  T *u = sm + Ly.u, *part = sm + Ly.part, *red = sm + Ly.red;
  const T *xs, *wv, *yv, *dv;
  T* tv;
  int ps;
  if constexpr (ROUTE == 0) {
    T *xw = sm + Ly.x, *ww = sm + Ly.w, *yw = sm + Ly.y, *dw = sm + Ly.dp;
    ps = Ly.ps;
    for (int e = tid; e < n * p; e += VC_THREADS) {
      const int i = e / p;
      xw[(size_t)i * ps + (e - i * p)] = X[e];
    }
    for (int i = tid; i < n; i += VC_THREADS) {
      ww[i] = w[(size_t)l * n + i];
      yw[i] = y[i];
    }
    for (int e = tid; e < n * q1; e += VC_THREADS) dw[e] = dpow[ln + e];
    xs = xw, wv = ww, yv = yw, dv = dw, tv = sm + Ly.t;
  } else {
    ps = p;
    xs = X, wv = w + (size_t)l * n, yv = y, dv = dpow + ln, tv = scratch + ln;
  }
  const T lt = Lt[l];
  for (int c = tid; c < ep; c += VC_THREADS) {
    const T s = sc[le + c];
    const T z = mul_rn(B[le + c], s);
    scv[c] = s;
    thl[c] = thrw[le + c] / s / lt;
    zt[c] = z;
    vt[c] = z;
    u[c] = z / s;
  }
  __syncthreads();

  const bool frozen = cert[l] != 0;
  if (!frozen) {
    for (int it = 0; it < iters; ++it) {
      vc_predict<T, ROUTE, QN>(xs, ps, n, p, q1, u, wv, yv, dv, tv, nullptr);
      __syncthreads();
      vc_transposed<T, ROUTE, QN>(xs, ps, n, p, q1, G, tv, part);
      __syncthreads();
      const T m = __ldg(mom + it);
      for (int c = tid; c < ep; c += VC_THREADS) {
        const T gv = vc_gather(part, G, ep, c) / scv[c];
        const T zn = soft(add_rn(vt[c], gv / lt), thl[c]);
        const T v = add_rn(zn, mul_rn(m, add_rn(zn, -zt[c])));
        zt[c] = zn;
        vt[c] = v;
        u[c] = v / scv[c];
      }
      __syncthreads();
    }
    for (int c = tid; c < ep; c += VC_THREADS) u[c] = zt[c] / scv[c];
    __syncthreads();
  }
  // u = B: the residual afresh and the certificate
  const T rr = vc_predict<T, ROUTE, QN>(xs, ps, n, p, q1, u, wv, yv, dv, tv,
                                        R + (size_t)l * n);
  __syncthreads();
  T floor_r = T(0);
  if constexpr (sizeof(T) < 8)
    floor_r = mul_rn(T(4 * FLT_EPSILON), sqrt(block_sum(rr, red)));
  vc_transposed<T, ROUTE, QN>(xs, ps, n, p, q1, G, tv, part);
  __syncthreads();
  T h = T(0);
  bool nan = false;
  for (int c = tid; c < ep; c += VC_THREADS) {
    const T a = adiag[le + c];
    const T gq = vc_gather(part, G, ep, c) / a;
    const T tq = thrw[le + c] / a;
    const T b = u[c];
    const T zq = add_rn(b, gq);
    T H = tabs(zq) > tq ? tabs(add_rn(gq, -mul_rn(tq, tsign(zq)))) : tabs(b);
    if constexpr (sizeof(T) < 8) {
      const T fl = add_rn(mul_rn(T(2 * FLT_EPSILON), tabs(b)),
                          floor_r / xwnorm[le + c]);
      if (H <= fl) H = T(0);
    }
    nan = nan || H != H;
    h = tmax(h, H);
    Bo[le + c] = b;
  }
  const bool any_nan = __syncthreads_or(nan);
  const T hmax = block_max(h, red);
  if (tid == 0) {
    const T mv = any_nan ? qnan<T>() : hmax;
    const T b0 = best[l];
    const int s = frozen ? stall[l] : (mv < b0 ? 0 : stall[l] + 1);
    const bool finite = tabs(mv) <= T(sizeof(T) == 4 ? FLT_MAX : DBL_MAX);
    const bool ok = s >= patience && mv < tol4 && finite;
    const bool strict = mv < tol;
    mx[l] = mv;
    best_o[l] = b0 != b0 || mv != mv ? qnan<T>() : (mv < b0 ? mv : b0);
    stall_o[l] = s;
    esc_o[l] = esc[l] || (!frozen && ok && !strict);
    cert_o[l] = frozen || strict || ok;
  }
}

template <typename T, int ROUTE, int QN>
cudaError_t vc_launch(const T* X, const T* y, const T* w, const T* dpow,
                      const T* sc, const T* Lt, const T* adiag,
                      const T* xwnorm, const T* thrw, const T* B,
                      const unsigned char* cert, const T* best,
                      const int* stall, const unsigned char* esc,
                      const T* mom, T* scratch, T* Bo, T* R, T* mx,
                      unsigned char* cert_o, T* best_o, int* stall_o,
                      unsigned char* esc_o, int k, int n, int p, int q1,
                      int iters, int patience, T tol, T tol4, int smem,
                      cudaStream_t s) {
  auto kern = vc_round_kernel<T, ROUTE, QN>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<k, VC_THREADS, smem, s>>>(X, y, w, dpow, sc, Lt, adiag, xwnorm,
                                   thrw, B, cert, best, stall, esc, mom,
                                   scratch, Bo, R, mx, cert_o, best_o,
                                   stall_o, esc_o, n, p, q1, iters, patience,
                                   tol, tol4);
  return cudaGetLastError();
}

template <typename T, int ROUTE>
cudaError_t vc_by_powers(int q1, const T* X, const T* y, const T* w,
                         const T* dpow, const T* sc, const T* Lt,
                         const T* adiag, const T* xwnorm, const T* thrw,
                         const T* B, const unsigned char* cert,
                         const T* best, const int* stall,
                         const unsigned char* esc, const T* mom, T* scratch,
                         T* Bo, T* R, T* mx, unsigned char* cert_o,
                         T* best_o, int* stall_o, unsigned char* esc_o,
                         int k, int n, int p, int iters, int patience, T tol,
                         T tol4, int smem, cudaStream_t s) {
#define CDT_VC_ARGS                                                          \
  X, y, w, dpow, sc, Lt, adiag, xwnorm, thrw, B, cert, best, stall, esc,     \
      mom, scratch, Bo, R, mx, cert_o, best_o, stall_o, esc_o, k, n, p, q1,  \
      iters, patience, tol, tol4, smem, s
  switch (q1) {  // degrees 0-2 with the powers' loops unrolled
    case 1: return vc_launch<T, ROUTE, 1>(CDT_VC_ARGS);
    case 2: return vc_launch<T, ROUTE, 2>(CDT_VC_ARGS);
    case 3: return vc_launch<T, ROUTE, 3>(CDT_VC_ARGS);
    default: return vc_launch<T, ROUTE, 0>(CDT_VC_ARGS);
  }
#undef CDT_VC_ARGS
}

template <typename T>
int vc_round(const T* X, const T* y, const T* w, const T* dpow, const T* sc,
             const T* Lt, const T* adiag, const T* xwnorm, const T* thrw,
             const T* B, const unsigned char* cert, const T* best,
             const int* stall, const unsigned char* esc, const T* mom,
             T* scratch, T* Bo, T* R, T* mx, unsigned char* cert_o,
             T* best_o, int* stall_o, unsigned char* esc_o, int k, int n,
             int p, int q1, int iters, int route, int patience, int smem,
             double tol, double tol4, cudaStream_t s) {
  if (n < 1 || p < 1 || q1 < 1 || iters < 0 || (route != 0 && route != 1) ||
      (route == 1 && scratch == nullptr) ||
      (size_t)smem != vc_layout<T>(n, p, q1, route).bytes)
    return (int)cudaErrorInvalidValue;
  if (k < 1) return (int)cudaGetLastError();
  auto go = route == 0 ? vc_by_powers<T, 0> : vc_by_powers<T, 1>;
  return (int)go(q1, X, y, w, dpow, sc, Lt, adiag, xwnorm, thrw, B, cert,
                 best, stall, esc, mom, scratch, Bo, R, mx, cert_o, best_o,
                 stall_o, esc_o, k, n, p, iters, patience, (T)tol, (T)tol4,
                 smem, s);
}

}  // namespace cdt

#define CDT_VC_ROUND(SUFFIX, T)                                               \
  extern "C" int cdt_vc_round_##SUFFIX(                                       \
      const void* X, const void* y, const void* w, const void* dpow,          \
      const void* sc, const void* Lt, const void* adiag, const void* xwnorm,  \
      const void* thrw, const void* B, const void* cert, const void* best,    \
      const void* stall, const void* esc, const void* mom, void* scratch,     \
      void* Bo, void* R, void* mx, void* cert_o, void* best_o, void* stall_o, \
      void* esc_o, int k, int n, int p, int q1, int iters, int route,         \
      int patience, int smem, double tol, double tol4, void* stream) {        \
    return cdt::vc_round<T>(                                                  \
        (const T*)X, (const T*)y, (const T*)w, (const T*)dpow, (const T*)sc,  \
        (const T*)Lt, (const T*)adiag, (const T*)xwnorm, (const T*)thrw,      \
        (const T*)B, (const unsigned char*)cert, (const T*)best,              \
        (const int*)stall, (const unsigned char*)esc, (const T*)mom,          \
        (T*)scratch, (T*)Bo, (T*)R, (T*)mx, (unsigned char*)cert_o,           \
        (T*)best_o, (int*)stall_o, (unsigned char*)esc_o, k, n, p, q1, iters, \
        route, patience, smem, tol, tol4, (cudaStream_t)stream);              \
  }

CDT_VC_ROUND(f32, float)
CDT_VC_ROUND(f64, double)
