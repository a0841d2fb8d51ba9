"""Varying-coefficient (local-polynomial kernel) regression suite
(counterpart of ``coordinatedescent_jl_tpu/models/varying_coefficient.py``;
see that module for the reference functions each one mirrors).

- smoothing kernels and the row-wise Kronecker expansion of the design;
- ``locpoly``: the unpenalised local fit, one batched normal-equation
  solve over the grid, with the rank-robust minimum-norm SVD solve for
  the points that come back non-finite or ill-conditioned;
- ``locpolyl1``: the L1 fit, either the sequential scan (a host loop over
  the grid: a warm-started weighted-Lasso solve per point through the
  block engine, ``build_blocked("wls")`` + ``solve_blocked``, so K1's wls
  form, K3/K4 with the screen off and K5 run on the card) or the batched
  execution (``_VcBatchOps``: coarse anchors through the scan, every
  other point certified and refined in chunks of lanes, every product a
  plain GEMM against the shared X);
- bandwidth selection (``lvocv_locpoly``, ``split_locpoly``,
  ``lvocv_locpolyl1``, sequential or batched), the support and
  interpolation utilities and the sandwich standard errors.

What differs from the JAX module:

- ``lax.scan`` / ``lax.map`` / ``lax.while_loop`` are host loops; a loop
  that branches on a device value reads it through ``utils/host.py``.
- ``torch.linalg.solve_ex`` / ``inv_ex`` stand for ``jnp.linalg.solve`` /
  ``inv``: a singular system gives non-finite numbers and a nonzero
  ``info`` instead of an exception, so a degenerate ``locpoly`` point
  reaches its fallback, ``utils.helpers.min_norm_lstsq`` on every device.
- The three-operand einsums of the batched execution are two GEMMs
  against X with the power tensor applied around them
  (``_VcBatchOps._pred`` / ``_xt``): ``torch.einsum`` may copy operands.
- ``scan_chunk`` is taken, checked and ignored.  The JAX package cuts
  the scan into device programs of that many points
  (``_locpolyl1_scan_chunked``) only to bound one program's run time;
  here the scan is a host loop of short kernels already.
- ``sparse_coefficients`` returns a torch sparse COO tensor in place of a
  BCOO; ``nse`` is checked (at least the nonzero count) but no padding
  slots are stored: a COO tensor has no static shape to keep.
- The batched chunks are not padded to ``grid_batch`` / ``cv_batch``
  lanes (JAX repeats a lane to fill the last chunk; lanes are
  independent, so the padding changes nothing).
- Visit orders for ``randomize=True`` come from a ``torch.Generator``
  seeded with ``seed`` and cannot reproduce ``jax.random``.

Every entry point runs on ``device`` (``None``: the GPU, raising when
there is none; ``"cpu"`` for the plain path on the CPU), where its inputs
are moved.  ``evaluate`` and the ``expand_*`` functions take tensors and
compute where they lie.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Union

import numpy as np
import torch

from ..ops.batched_certify import stall_escape_update
from ..ops.block_cd import (_np_dtype, _to_blocked_beta, build_blocked,
                            full_f32_matmuls, noise_floor_mask, secant_alpha,
                            solve_blocked)
from ..ops.prox import soft_threshold
from ..utils import host
from ..utils.helpers import (get_sigma, min_norm_lstsq, on_device, std_X,
                             target_device)
from ..utils.options import CDOptions, auto_batch_lanes, resolve_extrapolate

# ---------------------------------------------------------------------------
# Smoothing kernels
# ---------------------------------------------------------------------------


class GaussianKernel(NamedTuple):
    """``evaluate = exp(−(x−y)²/h)/h``: the reference's own form, not the
    N(0, h) density (no √π factor, h not squared)."""

    h: float


class EpanechnikovKernel(NamedTuple):
    """``0.75 (1 − u²)/h`` for ``|u| < 1`` with ``u = (x−y)/h``."""

    h: float


SmoothingKernel = Union[GaussianKernel, EpanechnikovKernel]


def create_kernel(kernel_type, h) -> SmoothingKernel:
    """The reference's ``createKernel`` factory."""
    return kernel_type(h)


def evaluate(kernel: SmoothingKernel, x, y):
    """Kernel weight(s), elementwise over the tensors ``x``/``y``
    (broadcast)."""
    if isinstance(kernel, GaussianKernel):
        return torch.exp(-((x - y) ** 2) / kernel.h) / kernel.h
    if isinstance(kernel, EpanechnikovKernel):
        u = (x - y) / kernel.h
        return torch.where(torch.abs(u) >= 1.0, torch.zeros_like(u),
                           0.75 * (1.0 - u * u) / kernel.h)
    raise TypeError(f"unsupported kernel: {type(kernel)!r}")


def _in_dtype(kernel: SmoothingKernel, dtype) -> SmoothingKernel:
    """``kernel`` with its bandwidth rounded to ``dtype`` (the JAX module
    casts ``h`` to the data's dtype), as a host float."""
    return type(kernel)(float(_np_dtype(dtype).type(float(kernel.h))))


# ---------------------------------------------------------------------------
# Design expansion
# ---------------------------------------------------------------------------


def _powers(d, q1: int):
    """``d^0, …, d^(q1−1)`` along a new last axis."""
    return d[..., None] ** torch.arange(q1, dtype=d.dtype, device=d.device)


def expand_X(X, z, z0, degree: int):
    """Row-wise Kronecker expansion: row i is
    ``X[i, :] ⊗ [1, (z_i − z0), …, (z_i − z0)^degree]``, feature-major and
    degree-minor (column ``j(degree+1)+l`` is ``X_j ⋅ d^l``)."""
    n, p = X.shape
    pw = _powers(z - z0, degree + 1)                       # (n, q1)
    return (X[:, :, None] * pw[:, None, :]).reshape(n, p * (degree + 1))


def _expand_lanes(X, dpow):
    """``expand_X`` for a batch of points at once: ``dpow (k, n, q1)`` the
    per-lane powers; returns ``(k, n, p(degree+1))``."""
    k, n, q1 = dpow.shape
    return (X[None, :, :, None] * dpow[:, :, None, :]).reshape(
        k, n, X.shape[1] * q1)


def expand_wX(w, X, z, z0, degree: int):
    """``Diag(w) ⋅ expand_X``."""
    return w[:, None] * expand_X(X, z, z0, degree)


def expand_Xt_w_X(w, X, z, z0, degree: int):
    """``eX' W eX``."""
    eX = expand_X(X, z, z0, degree)
    return eX.T @ (w[:, None] * eX)


def expand_Xt_w_Y(w, X, z, y, z0, degree: int):
    """``eX' W y``."""
    eX = expand_X(X, z, z0, degree)
    return eX.T @ (w * y)


# ---------------------------------------------------------------------------
# Local polynomial regression, low-dimensional
# ---------------------------------------------------------------------------


def _sqrt_weighted(X, z, y, z0s, degree: int, kernel, holdout=None):
    """The √w-scaled expanded designs ``(g, n, ep)`` and responses
    ``(g, n)`` at the points ``z0s (g,)``; ``holdout (g,)`` zeroes each
    lane's own row (leave one out)."""
    sw = torch.sqrt(evaluate(kernel, z[None, :], z0s[:, None]))   # (g, n)
    if holdout is not None:
        sw = sw.index_put((torch.arange(sw.shape[0], device=sw.device),
                           holdout), torch.zeros((), dtype=sw.dtype,
                                                 device=sw.device))
    wX = sw[:, :, None] * _expand_lanes(X, _powers(
        z[None, :] - z0s[:, None], degree + 1))
    return wX, sw * y[None, :]


def _locpoly_normal(X, z, y, z0s, degree: int, kernel):
    """The normal-equation fits at the points ``z0s (g,)``, batched:
    ``(coef (g, ep), relres (g,), info (g,))``.  ``relres`` is
    ``‖A·coef − b‖/‖b‖``, ~eps·cond(A) for an LU solve: the conditioning
    proxy that routes a near-singular point to the fallback."""
    wX, wy = _sqrt_weighted(X, z, y, z0s, degree, kernel)
    A = wX.mT @ wX
    b = (wX.mT @ wy[:, :, None])[..., 0]
    coef, info = torch.linalg.solve_ex(A, b)
    relres = (torch.linalg.vector_norm((A @ coef[..., None])[..., 0] - b,
                                       dim=-1)
              / torch.clamp_min(torch.linalg.vector_norm(b, dim=-1), 1e-30))
    return coef, relres, info


def _locpoly_lstsq(X, z, y, z0s, degree: int, kernel):
    """Rank-robust fits (√w-scaled design, minimum-norm SVD solve) at the
    points ``z0s``: the fallback for degenerate points."""
    return min_norm_lstsq(*_sqrt_weighted(X, z, y, z0s, degree, kernel))


def locpoly(X, z, y, zgrid, degree: int, kernel: SmoothingKernel = None, *,
            device=None):
    """Local polynomial regression on a grid (or at a single point):
    ``(p(degree+1), len(zgrid))``, or a vector for a scalar ``zgrid``
    (default kernel ``GaussianKernel(1)``).  One batched normal-equation
    solve over the grid; the points whose fit is non-finite, singular or
    ill-conditioned (relative normal-equation residual above 1e-3) are
    solved again by the minimum-norm SVD solve, after one counted host
    read of which points those are."""
    dev = target_device(device)
    X = on_device(X, dev)
    z = on_device(z, dev, X.dtype)
    y = on_device(y, dev, X.dtype)
    kernel = _in_dtype(GaussianKernel(1.0) if kernel is None else kernel,
                       X.dtype)
    zg = on_device(zgrid, dev, X.dtype)
    scalar = zg.ndim == 0
    zg = zg.reshape(-1)
    with full_f32_matmuls():
        out, relres, info = _locpoly_normal(X, z, y, zg, degree, kernel)
        bad = host.numpy(~torch.all(torch.isfinite(out), dim=1)
                         | (relres > 1e-3) | (info != 0))
        if bad.any():
            idx = torch.as_tensor(np.nonzero(bad)[0], device=dev)
            out[idx] = _locpoly_lstsq(X, z, y, zg[idx], degree, kernel)
    return out[0] if scalar else out.T


# ---------------------------------------------------------------------------
# locpolyl1: the varying-coefficient Lasso
# ---------------------------------------------------------------------------


def _group_mask_expanded(beta_e, p: int, degree: int):
    """The expanded group-support mask of one point ``(ep,)`` or of lanes
    ``(k, ep)``: all ``degree+1`` coordinates of feature j are in iff any
    of them is nonzero."""
    q1 = degree + 1
    grp = torch.any(beta_e.reshape(*beta_e.shape[:-1], p, q1) != 0, dim=-1)
    return torch.repeat_interleave(grp, q1, dim=-1)


def _masked_weighted_refit(eX, w, y, mask):
    """Weighted OLS on the masked columns without a dynamic shape: the full
    normal equations with the rows and columns off the mask replaced by
    the identity (so those coefficients are exactly 0)."""
    ep = eX.shape[1]
    A = eX.T @ (w[:, None] * eX)
    b = eX.T @ (w * y)
    eye = torch.eye(ep, dtype=A.dtype, device=A.device)
    A = torch.where(mask[:, None] & mask[None, :], A, eye)
    b = torch.where(mask, b, torch.zeros_like(b))
    return torch.linalg.solve_ex(A, b)[0]


def _batched_masked_refit(X, y, w, dpow, B):
    """``_masked_weighted_refit`` for ``k`` lanes on the expanded design
    ``eXl (k, n, ep)``, made once for the chunk from the shared X and the
    per-lane powers ``dpow (k, n, q1)``; ``w (k, n)``, ``B (k, ep)``.
    Returns ``(br, mask)``; ``br`` is exactly 0 off the mask."""
    k, n = w.shape
    p = X.shape[1]
    eXl = _expand_lanes(X, dpow)
    mask = _group_mask_expanded(B, p, dpow.shape[2] - 1)
    A = eXl.mT @ (w[:, :, None] * eXl)
    b = (eXl.mT @ (w * y[None, :])[:, :, None])[..., 0]
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    A = torch.where(mask[:, :, None] & mask[:, None, :], A, eye)
    b = torch.where(mask, b, torch.zeros_like(b))
    return torch.linalg.solve_ex(A, b)[0], mask


def _locpolyl1_core(X, z, y, zgrid, h: float, lam0: float, seed: int,
                    degree: int, kernel_type, opts: CDOptions, refit: bool):
    """The warm-started scan over ``zgrid`` (host floats in the data's
    dtype): at each point the secant-shifted warm start, the kernel
    weights, the expanded design with its weighted loadings, one wls
    solve through the block engine and the optional refit.  The carry
    ``(β, β_prev, z_k, z_km1)`` starts with both abscissae at
    ``zgrid[0]``, so the first two points take no shift.  Returns
    ``(out, out_refit)``, both ``(p(degree+1), len(zgrid))``."""
    n, p = X.shape
    ep = p * (degree + 1)
    kernel = kernel_type(h)
    key = torch.Generator().manual_seed(seed)
    extrap = resolve_extrapolate(opts, True)
    beta_b = beta_prev = _to_blocked_beta(
        torch.zeros((ep,), dtype=X.dtype, device=X.device), opts.block_size)
    z_k = z_km1 = zgrid[0]
    betas, refits = [], []
    for z0 in zgrid:
        # the start shifted along the last secant; zero coordinates stay
        # zero (support changes are the solver's)
        alpha = secant_alpha(z0, z_k, z_km1, X.dtype) if extrap else 0.0
        start = torch.where(beta_b != 0, beta_b + alpha * (beta_b - beta_prev),
                            torch.zeros_like(beta_b))
        w = evaluate(kernel, z, z0)
        eX = expand_X(X, z, z0, degree)
        prob = build_blocked("wls", opts, std_X(eX, w), X=eX, y=y, w=w)
        st = solve_blocked("wls", opts, prob, lam0, start, key)
        beta = st.beta.reshape(-1)[:ep]
        betas.append(beta)
        if refit:
            refits.append(_masked_weighted_refit(
                eX, w, y, _group_mask_expanded(beta, p, degree)))
        beta_prev, beta_b = beta_b, st.beta
        z_km1, z_k = z_k, z0
    out = torch.stack(betas, dim=1)
    return out, (torch.stack(refits, dim=1) if refit
                 else torch.zeros_like(out))


def _fista_coefs(iters: int, dtype):
    """The FISTA momentum coefficients ``(t_k − 1)/t_{k+1}``: the same for
    every lane and phase, so computed once on the host in ``dtype``."""
    npdt = _np_dtype(dtype).type
    coefs, t = [], npdt(1)
    for _ in range(iters):
        t_new = npdt(0.5) * (npdt(1) + np.sqrt(npdt(1) + npdt(4) * t * t))
        coefs.append(float((t - npdt(1)) / t_new))
        t = t_new
    return coefs


class _VcBatchOps:
    """One chunk of ``k`` lanes of the batched executions (the z-grid's
    ``_locpolyl1_batched_core`` and the LOO-CV's
    ``_lvocv_locpolyl1_one_h_batched``): per-lane kernel weights ``w
    (k, n)`` and powers ``dpow (k, n, q1)``, the closed-form diagonals,
    preconditioned FISTA with implicit matvecs, and the noise-floor-masked
    KKT certificate with the scan's float32 stall escape.  Lane k's
    expanded column (j, d) is ``X_j ⋅ dpow[k, :, d]``, so every product is
    a GEMM against the shared X (``_pred``, ``_xt``) with the powers
    applied around it.  ``thrw`` is an argument throughout (the LOO-CV's
    λ·σ changes per round)."""

    def __init__(self, X, z, y, kernel, z0, degree: int, opts: CDOptions,
                 holdout=None):
        n, p = X.shape
        q1 = degree + 1
        dt = X.dtype
        k = z0.shape[0]
        self.X, self.y, self.opts = X, y, opts
        self.n, self.p, self.q1, self.ep, self.k = n, p, q1, p * q1, k
        self.sub_f64 = dt.itemsize < 8
        self.eps = torch.finfo(dt).eps
        self.coefs = _fista_coefs(opts.block_iters, dt)
        w = evaluate(kernel, z[None, :], z0[:, None])            # (k, n)
        if holdout is not None:
            # leave one out: the held-out row's weight is 0 in its lane
            w = w.index_put((torch.arange(k, device=X.device), holdout),
                            torch.zeros((), dtype=dt, device=X.device))
        self.w = w
        self.dpow = _powers(z[None, :] - z0[:, None], q1)       # (k, n, q1)
        X2 = X * X
        # adiag_(j,d) = Σ_i w_i X_ij² d_i^{2d}; lamw = sqrt(adiag/n) (std_X's
        # divisor n); xwnorm uses w² (wls: Xw = w⊙X) for the step noise
        wd2 = w[:, :, None] * self.dpow * self.dpow
        self.adiag = torch.clamp_min(self._xt(wd2, X2), 1e-30)
        self.lamw = torch.sqrt(self.adiag / n)
        xw2 = self._xt(w[:, :, None] * wd2, X2)
        self.xwnorm = torch.sqrt(torch.clamp_min(xw2, 1e-60))
        # preconditioner: solve in β̃ = √a·β units
        self.sc = torch.sqrt(self.adiag)
        # the scaled Gram's Lipschitz bound per lane: 16 power steps from a
        # start with no symmetry the design could be orthogonal to; a lower
        # bound, so a 1.2 margin (the certificate's stall gate keeps any
        # divergence uncertified)
        ep = self.ep
        ar = torch.arange(ep, device=X.device)
        v0 = (1.0 - 2.0 * (ar % 2)).to(dt) * (1.0 + ar.to(dt) / ep)
        v = (v0 / torch.sqrt(torch.sum(v0 * v0))).expand(k, ep)
        nrm = torch.ones((k,), dtype=dt, device=X.device)
        for _ in range(16):
            u = self._Kv(v)
            nrm = torch.sqrt(torch.sum(u * u, dim=1))
            v = u / torch.clamp_min(nrm[:, None], 1e-30)
        self.Lt = 1.2 * torch.clamp_min(nrm, 1e-30)               # (k,)

    def _pred(self, u):
        """``Σ_(j,d) u[k, (j,d)] X[i, j] dpow[k, i, d]`` → ``(k, n)``: one
        GEMM ``X @ U`` over the lanes' columns, then the powers."""
        k, p, q1 = self.k, self.p, self.q1
        U = u.reshape(k, p, q1).permute(1, 0, 2).reshape(p, k * q1)
        M = (self.X @ U).reshape(self.n, k, q1).permute(1, 0, 2)
        return torch.sum(M * self.dpow, dim=2)

    def _xt(self, V, M=None):
        """``Σ_i V[k, i, d] M[i, j]`` → ``(k, ep)`` in (j, d) order: one GEMM
        ``Mᵀ @ V`` with ``M`` the shared X (default) or ``X∘X``."""
        M = self.X if M is None else M
        k, n, q1 = V.shape
        out = M.T @ V.permute(1, 0, 2).reshape(n, k * q1)       # (p, k·q1)
        return out.reshape(self.p, k, q1).permute(1, 0, 2).reshape(k,
                                                                    self.ep)

    def _Kv(self, v):
        u = v / self.sc
        Uw = (self.w * self._pred(u))[:, :, None] * self.dpow
        return self._xt(Uw) / self.sc

    def residual(self, B):
        return self.y[None, :] - self._pred(B)

    def certify(self, B, R, thrw):
        """Per-lane KKT violation magnitudes, the prox step written so that
        B cancels algebraically (as ``kkt_violation_lanes``)."""
        Cg = self._xt((self.w * R)[:, :, None] * self.dpow)
        gq = Cg / self.adiag
        tq = thrw / self.adiag
        zq = B + gq
        H = torch.abs(torch.where(torch.abs(zq) > tq,
                                  gq - tq * torch.sign(zq), -B))
        if self.sub_f64:
            rnorm = torch.sqrt(torch.sum(R * R, dim=1))
            return noise_floor_mask(
                H, B, 4 * self.eps * rnorm[:, None] / self.xwnorm)
        return noise_floor_mask(H, B)

    def fista_phase(self, B, cert, thrw):
        """``block_iters`` preconditioned FISTA steps, two GEMMs a step;
        certified lanes frozen."""
        sc, Lt = self.sc, self.Lt[:, None]
        thr_L = thrw / sc / Lt
        zt = vt = B * sc
        frozen = cert[:, None]
        for coef in self.coefs:
            rv = self.residual(vt / sc)
            gv = self._xt((self.w * rv)[:, :, None] * self.dpow) / sc
            z_new = soft_threshold(vt + gv / Lt, thr_L)
            z_new = torch.where(frozen, zt, z_new)
            vt = z_new + coef * (z_new - zt)
            zt = z_new
        return zt / sc

    def solve(self, B0, thrw, frozen=None):
        """Certify/refine rounds to the engine's KKT criterion (noise floor,
        and at float32 the per-lane stall escape), one counted host read a
        round.  Returns ``(B, R, cert, escaped)``; ``escaped`` marks the
        lanes accepted through the escape (never at float64).  The rounds
        run are kept in ``self.rounds``."""
        opts = self.opts
        tol = opts.opt_tol
        dev = B0.device
        if frozen is None:
            frozen = torch.zeros((self.k,), dtype=torch.bool, device=dev)
        B = B0
        R = self.residual(B)
        mx = torch.amax(self.certify(B, R, thrw), dim=1)
        cert = (mx < tol) | frozen
        patience = (opts.stall_patience if self.sub_f64
                    else np.iinfo(np.int32).max)
        best = mx
        stall = torch.zeros((self.k,), dtype=torch.int32, device=dev)
        esc = torch.zeros((self.k,), dtype=torch.bool, device=dev)
        rounds = 0
        while (rounds < 2 * opts.compact_rounds
               and not host.item(torch.all(cert))):
            with host.span("vc.refine_round"):
                B = self.fista_phase(B, cert, thrw)
                # the residual afresh each round: an incrementally kept R
                # would carry the float32 drift the certificate measures
                R = self.residual(B)
                mx = torch.amax(self.certify(B, R, thrw), dim=1)
                cert, best, stall, esc = stall_escape_update(
                    cert, best, stall, esc, mx, patience, tol)
            rounds += 1
        self.rounds = rounds
        return B, R, cert, esc


def _thr_scale(lam0: float, n: int, dtype) -> float:
    """``λ0·n`` rounded to ``dtype`` (a product of two dtype scalars in the
    JAX module)."""
    npdt = _np_dtype(dtype).type
    return float(npdt(lam0) * npdt(n))


@host.spanned("vc.batched")
def _locpolyl1_batched_core(X, z, y, zgrid_h, zgrid, h: float, lam0: float,
                            seed: int, degree: int, kernel_type,
                            opts: CDOptions, refit: bool, stride: int,
                            batch: int):
    """Batched z-grid execution: the scan over every ``stride``-th point
    (and the last), then every other point refined in chunks of ``batch``
    lanes from starts interpolated between the bracketing anchors (see the
    JAX ``_locpolyl1_batched_core`` for why the scheme is sound); the
    chunks run one after another.  ``zgrid_h`` the grid as host floats,
    ``zgrid`` as a tensor.  Returns ``(out, out_r, all_cert, n_escaped,
    rounds)``, ``rounds`` the refine rounds of all chunks; when
    ``all_cert`` is False the caller must fall back to the scan."""
    n, p = X.shape
    q1 = degree + 1
    ep = p * q1
    dev = X.device
    g = len(zgrid_h)
    kernel = kernel_type(h)
    cidx = np.arange(0, g, stride)
    if cidx[-1] != g - 1:
        cidx = np.append(cidx, g - 1)
    rest = np.setdiff1d(np.arange(g), cidx)
    with host.span("vc.anchors"):
        out_c, _ = _locpolyl1_core(X, z, y, [zgrid_h[i] for i in cidx], h,
                                   lam0, seed, degree, kernel_type, opts,
                                   False)
    betas_c = out_c.T                                       # (g_c, ep)
    if rest.size:
        seg = np.searchsorted(cidx, rest) - 1
        z_lo = zgrid[torch.as_tensor(cidx[seg], device=dev)]
        z_hi = zgrid[torch.as_tensor(cidx[seg + 1], device=dev)]
        z_r = zgrid[torch.as_tensor(rest, device=dev)]
        denom = torch.where(z_hi != z_lo, z_hi - z_lo, torch.ones_like(z_hi))
        a = torch.clamp((z_r - z_lo) / denom, 0.0, 1.0)
        seg_t = torch.as_tensor(seg, device=dev)
        starts = ((1.0 - a)[:, None] * betas_c[seg_t]
                  + a[:, None] * betas_c[seg_t + 1])
        thr = _thr_scale(lam0, n, X.dtype)
        k = min(batch, int(rest.size))
        rounds = 0
        parts = []
        for i in range(0, int(rest.size), k):
            with host.span("vc.refine"):
                ops = _VcBatchOps(X, z, y, kernel, z_r[i:i + k], degree, opts)
                B, _, cert, esc = ops.solve(starts[i:i + k], ops.lamw * thr)
            parts.append((B, cert, esc))
            rounds += ops.rounds
        certs = torch.cat([part[1] for part in parts])
        escs = torch.cat([part[2] for part in parts])
        all_cert, n_escaped = host.tolist(torch.stack([
            torch.all(certs).to(torch.int64),
            torch.sum(escs.to(torch.int64))]))
        betas = torch.zeros((g, ep), dtype=X.dtype, device=dev)
        betas[torch.as_tensor(cidx, device=dev)] = betas_c
        betas[torch.as_tensor(rest, device=dev)] = torch.cat(
            [part[0] for part in parts])
    else:
        betas, all_cert, n_escaped, rounds = betas_c, True, 0, 0
    if refit:
        kr = min(batch, g)
        out_r = []
        with host.span("vc.refit"):
            for i in range(0, g, kr):
                z0 = zgrid[i:i + kr]
                w = evaluate(kernel, z[None, :], z0[:, None])
                dpow = _powers(z[None, :] - z0[:, None], q1)
                out_r.append(_batched_masked_refit(X, y, w, dpow,
                                                   betas[i:i + kr])[0])
        out_r = torch.cat(out_r)
    else:
        out_r = torch.zeros_like(betas)
    return betas.T, out_r.T, bool(all_cert), int(n_escaped), rounds


@host.spanned("est.locpolyl1")
def locpolyl1(X, z, y, zgrid, degree: int, kernel: SmoothingKernel, lam0,
              refit: bool = True, options: CDOptions = CDOptions(), *,
              grid_batch: int | None = None,
              coarse_stride: int | None = None,
              scan_chunk: int | None = None, seed: int = 0,
              stats: dict | None = None, device=None):
    """Varying-coefficient Lasso on a grid of evaluation points: at each
    z0 the kernel weights, the expanded design and its weighted loadings,
    then a weighted Lasso solved by block CD with β warm-started across
    the grid (``warm_start`` forced on).  Returns ``(out, out_refit)``,
    both ``(p(degree+1), len(zgrid))``; ``out_refit`` holds the weighted
    OLS refits on each point's group support (zeros unless ``refit``).

    ``grid_batch > 0`` runs the batched execution: only every
    ``coarse_stride``-th point (default ``max(1, (len(zgrid) − 1) // 9)``,
    ~10 anchors) runs in the scan, and the others are certified and
    refined in chunks of ``grid_batch`` lanes; ``None`` resolves to 128
    lanes for sub-float64 CUDA tensors on grids of 16 or more points, else
    0 (the scan).  A batched run that does not certify every point warns
    (``RuntimeWarning``) and returns the scan's result.

    ``scan_chunk`` is taken for the JAX package's interface, checked
    (``>= 1``) and otherwise ignored (see the module docstring).

    ``stats``, if a dict, receives ``used_batched``, ``batched_certified``
    and ``stall_escaped_lanes``, as in the JAX package, and
    ``refine_rounds``, the batched execution's certify/refine rounds.
    """
    dev = target_device(device)
    X = on_device(X, dev)
    z = on_device(z, dev, X.dtype)
    y = on_device(y, dev, X.dtype)
    zg = on_device(zgrid, dev, X.dtype)
    opts = options.replace(warm_start=True)
    h = _in_dtype(kernel, X.dtype).h
    lam = float(_np_dtype(X.dtype).type(lam0))
    L = int(zg.shape[0])
    if grid_batch is None:
        grid_batch = auto_batch_lanes(X.dtype, dev, L, min_points=16)
    if coarse_stride is None:
        coarse_stride = max(1, (L - 1) // 9)
    if coarse_stride < 1:
        raise ValueError("coarse_stride must be >= 1")
    if grid_batch < 0:
        raise ValueError("grid_batch must be >= 0")
    if scan_chunk is not None and scan_chunk <= 0:
        raise ValueError("scan_chunk must be >= 1")
    if stats is not None:
        stats.update(used_batched=False, batched_certified=False,
                     stall_escaped_lanes=0, refine_rounds=0)
    zg_h = host.tolist(zg)
    with full_f32_matmuls():
        if grid_batch and L > max(2, coarse_stride):
            if stats is not None:
                # the attempt ran: used_batched stays True on a fallback
                stats["used_batched"] = True
            out, out_r, all_cert, n_esc, rounds = _locpolyl1_batched_core(
                X, z, y, zg_h, zg, h, lam, seed, degree, type(kernel), opts,
                refit, int(coarse_stride), int(grid_batch))
            if stats is not None:
                stats["refine_rounds"] = rounds
            if all_cert:
                if stats is not None:
                    stats.update(batched_certified=True,
                                 stall_escaped_lanes=n_esc)
                return out, out_r
            warnings.warn(
                "locpolyl1(grid_batch=...): batched refinement did not "
                "certify every grid point; falling back to the sequential "
                "scan (consider a larger options.compact_size or a smaller "
                "grid_batch)", RuntimeWarning)
        with host.span("vc.scan"):
            return _locpolyl1_core(X, z, y, zg_h, h, lam, seed, degree,
                                   type(kernel), opts, refit)


def refit_locpolyl1(X, z, y, z0, degree: int, kernel: SmoothingKernel,
                    beta_e, *, device=None):
    """Unpenalised local-polynomial refit at ``z0`` on the collapsed group
    support of ``beta_e``: ``(beta_refit, support_mask)``, ``beta_refit``
    with ``|S|(degree+1)`` entries and ``support_mask (p,)`` a bool tensor.
    The support comes to the host in one counted read."""
    dev = target_device(device)
    X = on_device(X, dev)
    p = X.shape[1]
    beta = on_device(beta_e, dev)
    S = torch.as_tensor(host.numpy(torch.any(
        beta.reshape(p, degree + 1) != 0, dim=1)), device=dev)
    br = locpoly(X[:, S], z, y, z0, degree, kernel, device=dev)
    return br, S


# ---------------------------------------------------------------------------
# Bandwidth selection
# ---------------------------------------------------------------------------


def _lvocv_locpolyl1_one_h(X, z, y, z_h, h: float, lam0: float, seed: int,
                           degree: int, kernel_type, opts: CDOptions,
                           sigma_iters: int = 10, points=None):
    """Sequential leave-one-out for one bandwidth, a host loop over the
    held-out rows: the screened weighted-OLS σ init, the λ·σ fixed point
    (≤ ``sigma_iters`` warm-started wls solves through the block engine,
    relative tolerance 1e-2, one counted host read a round), then the
    group-support weighted refit predicted at the held-out row.
    ``points=None`` returns the sum of the squared held-out errors over
    all rows; a list of row indices returns those rows' errors.  ``z_h``
    is ``z`` as host floats."""
    n, p = X.shape
    ep = p * (degree + 1)
    npdt = _np_dtype(X.dtype).type
    kernel = kernel_type(h)
    s_screen = min(10, ep)
    key = torch.Generator().manual_seed(seed)
    errs = []
    for i in (range(n) if points is None else points):
        z0 = z_h[i]
        w = evaluate(kernel, z, z0)
        w[i] = 0.0                                   # leave one out
        eX = expand_X(X, z, z0, degree)
        prob = build_blocked("wls", opts, std_X(eX, w), X=eX, y=y, w=w)
        # the σ init: weighted OLS residuals on the top-s columns
        wy = w * y
        idx = torch.topk(torch.abs(eX.T @ wy), s_screen).indices
        Xs = eX.index_select(1, idx)
        coef = torch.linalg.solve_ex(Xs.T @ (w[:, None] * Xs), Xs.T @ wy)[0]
        sig = npdt(host.item(get_sigma(w, y - Xs @ coef)))
        beta_b = _to_blocked_beta(torch.zeros((ep,), dtype=X.dtype,
                                              device=X.device),
                                  opts.block_size)
        for _ in range(sigma_iters):
            st = solve_blocked("wls", opts, prob, float(npdt(lam0) * sig),
                               beta_b, key)
            beta_b = st.beta
            signew = npdt(host.item(get_sigma(w, st.r)))
            if abs(signew - sig) / sig < 1e-2:
                break
            sig = signew
        mask = _group_mask_expanded(beta_b.reshape(-1)[:ep], p, degree)
        br = _masked_weighted_refit(eX, w, y, mask)
        errs.append(((eX[i] * mask) @ br - y[i]) ** 2)
    errs = torch.stack(errs)
    return torch.sum(errs) if points is None else errs


def _lvocv_chunk(X, z, y, idx, kernel, lam0: float, degree: int,
                 opts: CDOptions, sigma_iters: int):
    """One chunk of held-out rows ``idx`` of the batched LOO-CV, each a
    lane of ``_VcBatchOps`` with its own weight zeroed: the batched σ init,
    the batched λ·σ fixed point (lanes whose σ moved < 1e-2 relative
    freeze; one counted host read a round), the batched refit and the
    held-out predictions.  Returns ``(squared errors (k,), all certified
    (0-d bool), escaped (k,))``."""
    n, p = X.shape
    q1 = degree + 1
    ep = p * q1
    k = idx.shape[0]
    s_screen = min(10, ep)
    ops = _VcBatchOps(X, z, y, kernel, z[idx], degree, opts, holdout=idx)
    w, dpow = ops.w, ops.dpow
    wy = w * y[None, :]
    # the σ init, batched: weighted OLS on each lane's top-s columns
    c = torch.abs(ops._xt(wy[:, :, None] * dpow))
    sidx = torch.topk(c, s_screen, dim=1).indices                # (k, s)
    Xg = X[:, sidx // q1].permute(1, 0, 2)                       # (k, n, s)
    dg = torch.gather(dpow, 2, (sidx % q1)[:, None, :].expand(k, n,
                                                              s_screen))
    Xs = Xg * dg
    A = (Xs * w[:, :, None]).mT @ Xs + 1e-12 * torch.eye(
        s_screen, dtype=X.dtype, device=X.device)
    b = (Xs.mT @ wy[:, :, None])[..., 0]
    coef = torch.linalg.solve_ex(A, b)[0]
    r0 = y[None, :] - (Xs @ coef[:, :, None])[..., 0]
    wsum = torch.clamp_min(torch.sum(w, dim=1), 1e-30)
    sig = torch.sqrt(torch.sum(w * r0 * r0, dim=1) / wsum)
    thr = _thr_scale(lam0, n, X.dtype)
    B = torch.zeros((k, ep), dtype=X.dtype, device=X.device)
    done = torch.zeros((k,), dtype=torch.bool, device=X.device)
    ok = torch.ones((), dtype=torch.bool, device=X.device)
    esc = torch.zeros((k,), dtype=torch.bool, device=X.device)
    it = 0
    while it < sigma_iters and not host.item(torch.all(done)):
        B, R, cert, esc_i = ops.solve(B, ops.lamw * thr * sig[:, None],
                                      frozen=done)
        ok = ok & torch.all(cert)
        esc = esc | esc_i
        signew = torch.sqrt(torch.sum(w * R * R, dim=1) / wsum)
        conv = torch.abs(signew - sig) / torch.clamp_min(sig, 1e-30) < 1e-2
        sig = torch.where(done | conv, sig, signew)
        done = done | conv
        it += 1
    # the held-out row has z − z0 = 0: only its degree-0 entries predict
    br, mask = _batched_masked_refit(X, y, w, dpow, B)
    bm = (br * mask).reshape(k, p, q1)[:, :, 0]
    yh = torch.sum(X[idx] * bm, dim=1)
    return (yh - y[idx]) ** 2, ok, esc


def lvocv_locpolyl1(X, z, y, degree: int, h_arr, kernel_type, lam0,
                    options: CDOptions = CDOptions(), *, seed: int = 0,
                    cv_batch: int | None = None,
                    stats: dict | None = None, device=None):
    """Leave-one-out CV of the ``locpolyl1`` bandwidth: the sum of the
    squared held-out errors per bandwidth in ``h_arr`` (a host loop).

    ``cv_batch > 0`` runs each bandwidth batched (every held-out row a
    lane, chunks of ``cv_batch`` lanes, the λ·σ fixed point per lane);
    ``None`` resolves to 128 lanes for sub-float64 CUDA tensors, else 0
    (the sequential per-row path).  A bandwidth whose batched run does not
    certify is recomputed sequentially (``RuntimeWarning``); the rows a
    certified run accepted through the float32 stall escape are re-solved
    sequentially at the strict tolerance and their errors replaced.

    ``stats``, if a dict, receives ``batched_certified`` (every batched
    bandwidth certified), ``stall_escaped_lanes`` (0: no escaped lane stays
    in the output) and ``lanes_resolved_sequentially``."""
    dev = target_device(device)
    X = on_device(X, dev)
    z = on_device(z, dev, X.dtype)
    y = on_device(y, dev, X.dtype)
    opts = options.replace(warm_start=True)
    npdt = _np_dtype(X.dtype).type
    n = X.shape[0]
    if cv_batch is None:
        cv_batch = auto_batch_lanes(X.dtype, dev)
    z_h = host.tolist(z)
    lam = float(npdt(lam0))
    mses = []
    all_cert = True
    n_resolved = 0
    with full_f32_matmuls():
        for h in np.asarray(h_arr).tolist():
            hj = float(npdt(h))
            mse = None
            if cv_batch:
                kern = kernel_type(hj)
                k = min(int(cv_batch), n)
                parts = [_lvocv_chunk(X, z, y,
                                      torch.arange(i, min(i + k, n),
                                                   device=dev),
                                      kern, lam, degree, opts, 10)
                         for i in range(0, n, k)]
                errs = torch.cat([part[0] for part in parts])
                ok = torch.all(torch.stack([part[1] for part in parts]))
                esc = torch.cat([part[2] for part in parts])
                flags = host.numpy(torch.cat([ok.reshape(1), esc]))
                if flags[0]:
                    # an escaped lane stalled within 4·tol: re-solve its row
                    # at the strict tolerance instead of keeping it
                    esc_idx = np.nonzero(flags[1:])[0]
                    if esc_idx.size:
                        errs[torch.as_tensor(esc_idx, device=dev)] = (
                            _lvocv_locpolyl1_one_h(
                                X, z, y, z_h, hj, lam, seed, degree,
                                kernel_type, opts,
                                points=esc_idx.tolist()))
                        n_resolved += int(esc_idx.size)
                    mse = torch.sum(errs)
                else:
                    all_cert = False
                    warnings.warn(
                        "lvocv_locpolyl1(cv_batch=...): batched LOO run for "
                        f"h={h:g} did not certify; recomputing via the "
                        "sequential per-point path", RuntimeWarning)
            if mse is None:
                mse = _lvocv_locpolyl1_one_h(X, z, y, z_h, hj, lam, seed,
                                             degree, kernel_type, opts)
            mses.append(mse)
    if stats is not None:
        stats["batched_certified"] = bool(cv_batch) and all_cert
        stats["stall_escaped_lanes"] = 0
        stats["lanes_resolved_sequentially"] = n_resolved
    return torch.stack(mses)


def _lvocv_locpoly_one_h(X, z, y, kernel, degree: int, chunk: int = 256):
    """The unpenalised LOO score of one bandwidth: per held-out row the
    minimum-norm solve of the √w-scaled fit with that row's weight zeroed,
    batched in chunks of ``chunk`` rows (as the JAX ``lax.map``)."""
    n = X.shape[0]
    q1 = degree + 1
    errs = []
    for i in range(0, n, chunk):
        idx = torch.arange(i, min(i + chunk, n), device=X.device)
        coef = min_norm_lstsq(*_sqrt_weighted(X, z, y, z[idx], degree,
                                              kernel, holdout=idx))
        yh = torch.sum(X[idx] * coef[:, ::q1], dim=1)      # level coefs
        errs.append((yh - y[idx]) ** 2)
    return torch.sum(torch.cat(errs))


def lvocv_locpoly(X, z, y, degree: int, h_arr, kernel_type, *, device=None):
    """Leave-one-out CV of the ``locpoly`` bandwidth: the sum of squared
    held-out errors per bandwidth in ``h_arr``."""
    dev = target_device(device)
    X = on_device(X, dev)
    z = on_device(z, dev, X.dtype)
    y = on_device(y, dev, X.dtype)
    npdt = _np_dtype(X.dtype).type
    with full_f32_matmuls():
        return torch.stack([
            _lvocv_locpoly_one_h(X, z, y, kernel_type(float(npdt(h))),
                                 degree)
            for h in np.asarray(h_arr).tolist()])


def split_locpoly(X, z, y, X_test, z_test, y_test, zgrid, degree: int,
                  h_arr, kernel_type, *, device=None):
    """Train/test bandwidth scoring: per bandwidth, ``locpoly`` on the grid,
    β interpolated at each test z (``get_beta``), and the test set's sum
    of squared errors (over the test rows, whatever their number)."""
    dev = target_device(device)
    X = on_device(X, dev)
    dt = X.dtype
    z, y = on_device(z, dev, dt), on_device(y, dev, dt)
    X_test = on_device(X_test, dev, dt)
    z_test = on_device(z_test, dev, dt)
    y_test = on_device(y_test, dev, dt)
    zg = on_device(zgrid, dev, dt)
    npdt = _np_dtype(dt).type
    q1 = degree + 1
    mses = []
    for h in np.asarray(h_arr).tolist():
        beta_grid = locpoly(X, z, y, zg, degree, kernel_type(float(npdt(h))),
                           device=dev)
        bi = get_beta(zg, beta_grid, z_test, device=dev)       # (ep, m)
        yh = torch.sum(X_test * bi[::q1].T, dim=1)
        mses.append(torch.sum((y_test - yh) ** 2))
    return torch.stack(mses)


# ---------------------------------------------------------------------------
# Support and interpolation utilities
# ---------------------------------------------------------------------------


def get_beta(zgrid, beta_grid, z0, *, device=None):
    """β linearly interpolated between the two grid points that bracket
    ``z0``: ``(1−α)·β(z1) + α·β(z2)`` with ``α = (z0−z1)/(z2−z1)`` (the
    reference swaps the two weights; the JAX package corrects that, and
    so does this port); out-of-range ``z0`` clamps to the boundary column.
    A scalar ``z0`` gives ``(ep,)``, a vector of m points ``(ep, m)``."""
    dev = target_device(device)
    zgrid = on_device(zgrid, dev)
    beta_grid = on_device(beta_grid, dev)
    z0 = on_device(z0, dev, zgrid.dtype)
    scalar = z0.ndim == 0
    z0 = z0.reshape(-1)
    m = zgrid.shape[0]
    id2 = torch.clamp(torch.searchsorted(zgrid, z0), 0, m - 1)
    id1 = torch.clamp(torch.searchsorted(zgrid, z0, right=True) - 1, 0,
                      m - 1)
    z1, z2 = zgrid[id1], zgrid[id2]
    denom = torch.where(id1 == id2, torch.ones_like(z1), z2 - z1)
    alpha = torch.clamp((z0 - z1) / denom, 0.0, 1.0)
    out = (1.0 - alpha) * beta_grid[:, id1] + alpha * beta_grid[:, id2]
    return out[:, 0] if scalar else out


def get_nonzero_coordinates(beta_e, p: int, degree: int, expanded: bool, *,
                            device=None):
    """The group-collapsed support: feature j is in iff any of its
    ``degree+1`` coordinates is nonzero; ``(p,)``, or repeated to the
    expanded ``(p(degree+1),)`` layout."""
    beta_e = on_device(beta_e, target_device(device))
    if expanded:
        return _group_mask_expanded(beta_e, p, degree)
    return torch.any(beta_e.reshape(p, degree + 1) != 0, dim=1)


def sparse_coefficients(beta_grid, *, nse: int | None = None, device=None):
    """A sparse COO view (coalesced) of a dense ``(ep, m)`` coefficient
    grid, the boundary form of the reference's ``SparseMatrixCSC`` return.
    ``nse``, if given, must be at least the number of nonzeros (the JAX
    package pads a BCOO to it for a static shape; COO stores no padding)."""
    dense = on_device(beta_grid, target_device(device))
    sp = dense.to_sparse().coalesce()
    if nse is not None and nse < sp._nnz():
        raise ValueError(f"nse={nse} is below the {sp._nnz()} nonzeros")
    return sp


def get_residuals(X, z, y, zgrid, beta_grid, degree: int,
                  kernel: SmoothingKernel = None, *, device=None):
    """``ε̂_i = y_i − x_i' β̂(z_i)`` with the level coefficients interpolated
    from the grid, for every row at once (``kernel`` is unused, as in the
    reference)."""
    dev = target_device(device)
    X = on_device(X, dev)
    z = on_device(z, dev, X.dtype)
    y = on_device(y, dev, X.dtype)
    zg = on_device(zgrid, dev, X.dtype)
    bi = get_beta(zg, on_device(beta_grid, dev, X.dtype), z, device=dev)
    return y - torch.sum(X * bi[::degree + 1].T, dim=1)


# ---------------------------------------------------------------------------
# Standard errors
# ---------------------------------------------------------------------------


def _sandwich_level(X, z, z0, degree: int, kernel, mid_w):
    """``diag_level[(X'WX)⁻¹ X'M X (X'WX)⁻¹]`` with ``M = Diag(mid_w(w))``,
    the degree-0 entry of every feature."""
    w = evaluate(kernel, z, z0)
    A = torch.linalg.inv_ex(expand_Xt_w_X(w, X, z, z0, degree))[0]
    var = A @ expand_Xt_w_X(mid_w(w), X, z, z0, degree) @ A
    return torch.diagonal(var)[::degree + 1]


def get_standard_error(X, z, sigma2, z0, degree: int,
                       kernel: SmoothingKernel, *, device=None):
    """Sandwich variance of each feature's level coefficient,
    ``σ² ⋅ diag_level[(X'WX)⁻¹ X'W²X (X'WX)⁻¹]``.  The reference takes
    ``σ2`` and never multiplies by it; the JAX package applies the
    intended scaling, and so does this port."""
    dev = target_device(device)
    X = on_device(X, dev)
    z = on_device(z, dev, X.dtype)
    z0 = on_device(z0, dev, X.dtype)
    with full_f32_matmuls():
        return on_device(sigma2, dev, X.dtype) * _sandwich_level(
            X, z, z0, degree, kernel, lambda w: w * w)


def get_standard_error_hew(X, z, eps_sqr, z0, degree: int,
                           kernel: SmoothingKernel, *, device=None):
    """The heteroscedasticity-robust sandwich: the middle matrix weights
    ``w² ε̂²``."""
    dev = target_device(device)
    X = on_device(X, dev)
    z = on_device(z, dev, X.dtype)
    z0 = on_device(z0, dev, X.dtype)
    eps_sqr = on_device(eps_sqr, dev, X.dtype)
    with full_f32_matmuls():
        return _sandwich_level(X, z, z0, degree, kernel,
                               lambda w: w * w * eps_sqr)
