"""Estimators: Lasso, Sqrt-Lasso, Scaled-Lasso, Feasible Lasso (counterpart
of ``coordinatedescent_jl_tpu/models/lasso.py``).

The outer fixed-point loops of the scaled and the feasible Lasso are host
loops around the block engine, with one counted host read per round (the
new σ, or the loadings' relative change); the solver state, the cached
gradient and the working-set cache carry across rounds as in the JAX
package.  Every estimator runs on ``device`` (``None``: the GPU, raising
when there is none; ``"cpu"`` for the plain path on the CPU), where the
inputs are moved."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.block_cd import (_blocks_matvec, _compact_mode, _empty_ws_cache,
                            _init_state, _np_dtype, _pad_to_blocks,
                            _path_point, _solve_at_lambda_ws,
                            _to_blocked_beta, _unblock, build_blocked,
                            coordinate_descent, full_f32_matmuls,
                            solve_blocked)
from ..ops.losses import LeastSquaresLoss, SqrtLassoLoss
from ..ops.prox import ProxL1
from ..utils import host
from ..utils.helpers import (find_init_residuals, find_init_sigma,
                             get_loadings_blocked, on_device, sample_std,
                             std_X, target_device)
from ..utils.options import CDOptions, IterLassoOptions, resolve_extrapolate

_INITS = ("screening", "init_std", "warm_start")


class LassoSolution(NamedTuple):
    """Result record: dense coefficients (zeros encode sparsity), the
    residuals ``y − Xβ``, the penalty and the residual scale estimate."""

    x: torch.Tensor
    residuals: torch.Tensor
    penalty: ProxL1
    sigma: Optional[torch.Tensor]


@host.spanned("est.lasso")
def lasso(X, y, lam, weights=None, options: CDOptions = CDOptions(), *,
          seed: int = 0, device=None) -> LassoSolution:
    """(Weighted) Lasso ``min ‖y−Xβ‖²/(2n) + λ Σ ω_j |β_j|``; σ is the
    sample std of the residuals.  Runs on ``device`` (``None``: the GPU,
    raising when there is none; ``"cpu"`` for the plain path on the CPU),
    where the inputs are moved."""
    dev = target_device(device)
    X = on_device(X, dev)
    y = on_device(y, dev, X.dtype)
    g = ProxL1(float(lam), None if weights is None else
               on_device(weights, dev, X.dtype))
    beta0 = torch.zeros((X.shape[1],), dtype=X.dtype, device=dev)
    beta, r = coordinate_descent(beta0, LeastSquaresLoss(y, X), g, options,
                                 seed=seed, device=dev)
    return LassoSolution(beta, r, g, sample_std(r))


def _blocked_weights(v, B):
    """(p,) → (nb, B) with 1-padding (penalty weights of padded columns)."""
    return _pad_to_blocks(v, B, fill=1.0).reshape(-1, B)


def _check_init(init_procedure: str):
    if init_procedure not in _INITS:
        raise ValueError("init_procedure must be one of "
                         "'screening' | 'init_std' | 'warm_start'")


@host.spanned("est.sqrt_lasso")
def sqrt_lasso(X, y, lam, weights=None, options: CDOptions = CDOptions(), *,
               standardize_X: bool = True, seed: int = 0,
               device=None) -> LassoSolution:
    """Sqrt-Lasso ``min ‖y−Xβ‖₂ + λ Σ ω_j |β_j|``.  When ``weights`` is None
    and ``standardize_X`` is True the column RMS loadings are the penalty
    weights."""
    dev = target_device(device)
    X = on_device(X, dev)
    y = on_device(y, dev, X.dtype)
    if weights is None and standardize_X:
        weights = std_X(X)
    g = ProxL1(float(lam), None if weights is None else
               on_device(weights, dev, X.dtype))
    beta0 = torch.zeros((X.shape[1],), dtype=X.dtype, device=dev)
    beta, r = coordinate_descent(beta0, SqrtLassoLoss(y, X), g, options,
                                 seed=seed, device=dev)
    return LassoSolution(beta, r, g, sample_std(r))


def _scaled_lasso_core(X, y, lam: float, lamw, beta0, key,
                       opts: IterLassoOptions):
    """The joint (β, σ) loop: a Lasso solve at ``λ·σ``, then ``σ ←
    sqrt(Σ r²/n)``, until the relative σ change is below ``opt_tol``.
    Returns ``(beta, r, sig_used)``, ``sig_used`` the σ of the last solve
    (not the last σ computed)."""
    n = y.shape[0]
    dtype = X.dtype
    npdt = _np_dtype(dtype).type
    cd = opts.options_cd
    prob = build_blocked("ls", cd, lamw, X=X, y=y)
    beta_b = _to_blocked_beta(beta0, cd.block_size)

    if opts.init_procedure == "screening":
        sig = host.item(find_init_sigma(X, y, opts.s_init))
    elif opts.init_procedure == "init_std":
        sig = float(npdt(opts.sigma_init))
    else:
        sig = host.item(sample_std(y - _blocks_matvec(prob.Xb, beta_b)))

    n_scale = float(n)
    # the state (residuals, the λ-independent cached gradient) and the
    # working-set cache carry across the σ rounds
    st = _init_state("ls", prob, beta_b, key)
    nc = _compact_mode("ls", cd, prob, dtype)
    cache = _empty_ws_cache("ls", prob, nc, cd) if nc else None
    # the σ rounds move the penalty along the λ·σ abscissa: the λ path's
    # secant start (an oscillating σ gives α < 0, which the clip skips)
    extrap = bool(nc) and resolve_extrapolate(cd, True)
    sig_used = sig
    lam_new = float(npdt(lam) * npdt(sig))
    secant = (st.beta, lam_new, lam_new)
    it, done = 0, False
    while not done and it < opts.max_iter:
        lam_new = float(npdt(lam) * npdt(sig))
        st, cache, secant = _path_point("ls", cd, prob, st, cache, lam_new,
                                        n_scale, secant, extrap)
        signew = host.item(torch.sqrt(torch.sum(st.r * st.r) / n))
        done = bool(abs(npdt(signew) - npdt(sig)) / npdt(sig)
                    < npdt(opts.opt_tol))
        sig_used = sig
        if not done:
            sig = signew
        it += 1
    return _unblock(st.beta, beta0.shape[0]), st.r, sig_used


@host.spanned("est.scaled_lasso")
def scaled_lasso(X, y, lam, weights=None,
                 options: IterLassoOptions = IterLassoOptions(), *,
                 beta0=None, seed: int = 0, device=None) -> LassoSolution:
    """Scaled Lasso: alternate Lasso solves at ``λ·σ`` and the consensus σ
    update ``σ ← sqrt(Σ r² / n)`` until the relative σ change is below
    ``options.opt_tol``.  The returned penalty's level is ``λ·σ`` of the
    last solve."""
    _check_init(options.init_procedure)
    dev = target_device(device)
    X = on_device(X, dev)
    y = on_device(y, dev, X.dtype)
    p = X.shape[1]
    lamw = (torch.ones((p,), dtype=X.dtype, device=dev) if weights is None
            else on_device(weights, dev, X.dtype))
    beta0 = (torch.zeros((p,), dtype=X.dtype, device=dev) if beta0 is None
             else on_device(beta0, dev, X.dtype))
    key = torch.Generator().manual_seed(seed)
    with full_f32_matmuls():
        beta, r, sig_used = _scaled_lasso_core(X, y, float(lam), lamw, beta0,
                                               key, options)
    npdt = _np_dtype(X.dtype).type
    g = ProxL1(float(npdt(lam) * npdt(sig_used)), lamw)
    return LassoSolution(beta, r, g, sample_std(r))


def _feasible_lasso_core(X, y, lam0: float, beta0, key,
                         opts: IterLassoOptions):
    """The loading rounds: a weighted Lasso at the loadings ``Γ``, then
    ``Γ_j ← sqrt(mean((X_ij r_i)²))`` from its residuals, until ``max|ΔΓ| /
    maxΓ < opt_tol``.  Returns ``(beta, r, loadings)``."""
    dtype = X.dtype
    cd = opts.options_cd
    B = cd.block_size
    p = X.shape[1]
    prob = build_blocked("ls", cd, torch.ones((p,), dtype=dtype,
                                              device=X.device), X=X, y=y)
    beta_b = _to_blocked_beta(beta0, B)

    if opts.init_procedure == "screening":
        r = find_init_residuals(X, y, opts.s_init)
    elif opts.init_procedure == "init_std":
        # one solve with the column RMS loadings at λ0·σ_init
        npdt = _np_dtype(dtype).type
        st0 = solve_blocked("ls", cd,
                            prob._replace(lamw=_blocked_weights(std_X(X), B)),
                            float(npdt(lam0) * npdt(opts.sigma_init)), beta_b,
                            key)
        beta_b, r = st0.beta, st0.r
    else:
        r = y - _blocks_matvec(prob.Xb, beta_b)
    # from the blocked layout: no design-sized temporary in the rounds
    with host.span("feasible.loadings"):
        gam = get_loadings_blocked(prob.Xb, r, p)
        host.settle(gam)

    n_scale = float(y.shape[0])
    st = _init_state("ls", prob, beta_b, key)
    nc = _compact_mode("ls", cd, prob, dtype)
    cache = _empty_ws_cache("ls", prob, nc, cd) if nc else None
    it, done = 0, False
    while not done and it < opts.max_iter:
        with host.span("feasible.round"):
            # the cached gradient does not depend on the penalty weights, so
            # it (and the raw-column working-set cache) survives the loading
            # update
            prob_g = prob._replace(lamw=_blocked_weights(gam, B))
            if cd.warm_start:
                st, cache = _solve_at_lambda_ws("ls", cd, prob_g, lam0, st,
                                                n_scale, cache)
            else:
                st = solve_blocked("ls", cd, prob_g, lam0,
                                   torch.zeros_like(st.beta), key)
            with host.span("feasible.loadings"):
                gam_new = get_loadings_blocked(prob.Xb, st.r, p)
                done = host.item(torch.max(torch.abs(gam - gam_new))
                                 / torch.max(gam_new) < opts.opt_tol)
        gam = gam_new
        it += 1
    return _unblock(st.beta, p), st.r, gam


@host.spanned("est.feasible_lasso")
def feasible_lasso(X, y, lam0, options: IterLassoOptions = IterLassoOptions(),
                   *, beta0=None, seed: int = 0, device=None) -> LassoSolution:
    """Feasible (heteroscedastic) Lasso: re-estimate the penalty loadings
    ``Γ_j = sqrt(mean((X_ij ε_i)²))`` from the residuals each round until
    ``max|Γold − Γ| / maxΓ < options.opt_tol``.  The returned penalty
    carries the final loadings."""
    _check_init(options.init_procedure)
    dev = target_device(device)
    X = on_device(X, dev)
    y = on_device(y, dev, X.dtype)
    p = X.shape[1]
    beta0 = (torch.zeros((p,), dtype=X.dtype, device=dev) if beta0 is None
             else on_device(beta0, dev, X.dtype))
    key = torch.Generator().manual_seed(seed)
    with full_f32_matmuls():
        beta, r, gam = _feasible_lasso_core(X, y, float(lam0), beta0, key,
                                            options)
    return LassoSolution(beta, r, ProxL1(float(lam0), gam), sample_std(r))
