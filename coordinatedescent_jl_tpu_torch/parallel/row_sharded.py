"""Observation-sharded (data-parallel) and tile-sharded block-coordinate
descent (counterpart of ``coordinatedescent_jl_tpu/parallel/row_sharded.py``;
see that module's docstring for the scheme): the rows of ``X`` (and of
``y`` and the WLS weights) partitioned over the ``"obs"`` axis, β
replicated; the per-block Grams an exact psum computed once; each block
visit one psum of the local gradient ``Xw_b' r_local`` (a ``B``-vector),
the in-block Gram recursion replicated, the residual update local.  With a
``feat_axis`` the design is tiled (rows over ``axis``, columns over
``feat_axis``): column blocks are solved exactly within a feature shard
and merged block-Jacobi across feature shards (safeguarded ``t = 1``
against ``t = 1/D``, the exact-sparsity snap).

What differs from the JAX module:

- SPMD ranks and host control flow, as ``sharded_cd.py``.  The visit
  order and the active mask are the same on every rank of an obs group
  (the generator is seeded from ``(seed, feature rank)``; the mask comes
  from psum'd gradients), so the per-visit psum runs on all of them.
- A block visit's psum'd gradient cannot go through the fused active pass
  K1 (one collective per visit): the visit is plain PyTorch, as the
  reference runs it in plain XLA.  The full check's local gradient
  ``c[b] = Xw_b' r_local`` is K5's function: on the card it runs K5, then
  one all_reduce.
- Dropped: ``_feat_max``'s all_gather workaround (``all_reduce(MAX)``)
  and the host-chunked scan behind ``lasso_path_row_sharded(scan_chunk=)``
  with its segment loop (``ops/batched_certify.py::run_chunked_segments``,
  row_sharded.py:610-622 there; ``scan_chunk`` is taken, checked and
  ignored: the scan is a host loop already).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.lasso import LassoSolution
from ..models.lasso_path import LassoPath
from ..ops.block_cd import (_blockify_cols, _block_grams, _blocks_matvec,
                            _eps, _full_gradient_c, _ls_candidate, _np_dtype,
                            _sqrt_candidate, _visit_block, full_f32_matmuls,
                            noise_floor_mask)
from ..ops.losses import LeastSquaresLoss, SqrtLassoLoss, WeightedLSLoss
from ..ops.prox import ProxL1, ProxZero, as_l1
from ..utils import host
from ..utils.helpers import on_device, sample_std
from ..utils.options import CDOptions, use_kernels
from ._collectives import all_gather, axis_rank, axis_size, pmax, psum
from .distributed import rank_device
from .sharded_cd import _shard_chunk, rank_generator


class RowProblem(NamedTuple):
    """A rank's blocked tile of a row-partitioned problem."""

    Xb: torch.Tensor      # (nb, n_local, B) local rows
    Xwb: torch.Tensor     # w-scaled twin (the same tensor for ls / sqrt)
    y: torch.Tensor       # (n_local,)
    wrow: torch.Tensor    # (n_local,) local row weights (wls)
    lamw: torch.Tensor    # (nb, B) penalty loadings
    valid: torch.Tensor   # (nb, B) real (non-pad) columns
    Kb: torch.Tensor      # (nb, B, B) psum'd exact block Grams Xw'X
    adiag: torch.Tensor   # (nb, B) diagonal of Kb
    xwnorm: torch.Tensor  # (nb, B) ‖Xw_j‖ over ALL rows (psum'd)


class _Axes(NamedTuple):
    obs: object               # the obs axis's process group
    feat: Optional[object]    # the feature axis's group (tiled mesh)
    n_feat: int
    kernels: bool             # K5 for the local gradient


def _row_build(kind, Xl, yl, w, lamw_b, valid_b, B, ax: _Axes) -> RowProblem:
    Xb = _blockify_cols(Xl, B)
    Xwb = Xb * w[None, :, None] if kind == "wls" else Xb
    Kb = psum(_block_grams(Xwb, Xb), ax.obs)
    adiag = torch.diagonal(Kb, dim1=1, dim2=2)
    if kind == "wls":
        xw2 = psum(torch.einsum("bnk,bnk->bk", Xwb, Xwb), ax.obs)
    else:
        xw2 = adiag
    xwnorm = torch.sqrt(torch.clamp_min(xw2, 0.0))
    return RowProblem(Xb, Xwb, yl, w, lamw_b, valid_b, Kb, adiag, xwnorm)


def _row_rsqr(r, ax: _Axes):
    return psum(torch.dot(r, r), ax.obs)


def _row_full_c(prob: RowProblem, r, ax: _Axes):
    """The engine's full gradient (K5 on the card) with the n-contraction
    psum'd over the row shards."""
    return psum(_full_gradient_c("ls", prob, r, ax.kernels), ax.obs)


def _feat_max(x, ax: _Axes):
    return x if ax.feat is None else pmax(x, ax.feat)


def _row_full_check(kind, prob: RowProblem, beta_b, r, rsqr, lam0, n_scale,
                    opt_tol, ax: _Axes):
    """Order-independent KKT sweep on the exact gradient (one local K5
    sweep + one ``(p_local,)`` psum).  Returns ``(active, rsqr, maxh)``."""
    if kind == "sqrt":
        rsqr = _row_rsqr(r, ax)
    c = _row_full_c(prob, r, ax)
    if kind == "sqrt":
        val, _, _ = _sqrt_candidate(beta_b, c, prob.adiag, rsqr, lam0,
                                    prob.lamw)
    else:
        val = _ls_candidate(beta_b, c, prob.adiag, lam0, prob.lamw, n_scale)
    habs = torch.abs(torch.where(prob.valid, val - beta_b,
                                 torch.zeros_like(beta_b)))
    if beta_b.dtype.itemsize < 8:
        rnorm = torch.sqrt(_row_rsqr(r, ax))
        habs = noise_floor_mask(
            habs, beta_b, 4 * _eps(beta_b.dtype) * rnorm
            / torch.clamp_min(prob.xwnorm, 1e-30))
    else:
        habs = noise_floor_mask(habs, beta_b)
    maxh = _feat_max(torch.max(habs), ax)
    viol = torch.any(habs >= opt_tol, dim=1)
    active = torch.any(beta_b != 0, dim=1) | viol
    return active, rsqr, maxh


def _tile_objectives(kind, prob: RowProblem, r0, dr, beta0, dbeta, ts, lam0,
                     n_scale, ax: _Axes):
    """The global objective at each step of ``ts``: the data term psum'd
    over the obs axis, the penalty over the feature axis."""
    zero = torch.zeros_like(beta0)
    pens = lam0 * psum(torch.stack([
        torch.sum(torch.where(prob.valid,
                              prob.lamw * torch.abs(beta0 + t * dbeta),
                              zero)) for t in ts]), ax.feat)
    out = []
    for i, t in enumerate(ts):
        r = r0 + t * dr
        if kind == "wls":
            rn2 = psum(torch.dot(prob.wrow * r, r), ax.obs)
        else:
            rn2 = _row_rsqr(r, ax)
        f = (torch.sqrt(torch.clamp_min(rn2, 0.0)) if kind == "sqrt"
             else rn2 / (2.0 * n_scale))
        out.append(f + pens[i])
    return out


def _row_active_pass(kind, prob: RowProblem, beta_b, r, rsqr, active, lam0,
                     n_scale, randomize: bool, key, ax: _Axes,
                     opt_tol=0.0):
    """One pass over the active blocks: per visited block one psum of the
    local gradient, the replicated in-block Gram recursion, the local-row
    residual update; on a tiled mesh then the safeguarded merge over the
    feature axis.  Returns ``(beta, r, rsqr, active, maxh)``."""
    nb, B = prob.lamw.shape
    if randomize:
        border = torch.randperm(nb, generator=key).tolist()
        corder = torch.randperm(B, generator=key).tolist()
    else:
        border, corder = range(nb), list(range(B))
    r0, beta0 = r, beta_b
    act = host.tolist(active)
    beta = beta_b.clone()
    maxh = torch.zeros((), dtype=beta.dtype, device=beta.device)
    for b in border:
        if not act[b]:
            continue
        c = psum(prob.Xwb[b].T @ r, ax.obs)
        bb = beta[b].clone()
        bb2, rsqr, mh = _visit_block(kind, prob.Kb[b], bb, prob.lamw[b],
                                     lam0, c, rsqr, n_scale, corder)
        r = r - prob.Xb[b] @ (bb2 - bb)
        beta[b] = bb2
        maxh = torch.maximum(maxh, mh)
    if ax.feat is not None:
        maxh = pmax(maxh, ax.feat)
        dbeta = beta - beta0
        dr = psum(r - r0, ax.feat)
        if ax.n_feat > 1:
            one = torch.ones((), dtype=r0.dtype, device=r0.device)
            ts = (one, one / ax.n_feat)
            p_full, p_avg = _tile_objectives(kind, prob, r0, dr, beta0,
                                             dbeta, ts, lam0, n_scale, ax)
            t = torch.where(p_full <= p_avg, ts[0], ts[1])
            r, beta_new = r0 + t * dr, beta0 + t * dbeta
            delta = torch.where((beta == 0) & (torch.abs(beta_new) <= opt_tol),
                                beta_new, torch.zeros_like(beta_new))
            beta = beta_new - delta
            corr = (_blocks_matvec(prob.Xb, delta)
                    if host.item(torch.any(delta != 0))
                    else torch.zeros_like(r))
            r = r + psum(corr, ax.feat)
        else:
            r = r0 + dr
            beta = beta0 + dbeta
        if kind == "sqrt":
            rsqr = _row_rsqr(r, ax)
    return beta, r, rsqr, torch.any(beta != 0, dim=1), maxh


def _row_solve_at_lambda(kind, opts: CDOptions, prob: RowProblem, lam0,
                         beta_b, r, rsqr, active, key, n_scale, ax: _Axes):
    """The engine's epoch loop on the row layout; every convergence scalar
    comes out of a collective."""
    dtype = beta_b.dtype
    tol = float(_np_dtype(dtype).type(opts.opt_tol))
    patience = (opts.stall_patience if dtype.itemsize < 8
                else np.iinfo(np.int32).max)
    it, conv, done = 0, True, False
    best, stall = math.inf, 0
    while not done and it < opts.max_iter:
        host.COUNTS["epochs"] += 1
        was_full = conv
        if was_full:
            active, rsqr, maxh = _row_full_check(kind, prob, beta_b, r, rsqr,
                                                 lam0, n_scale, opts.opt_tol,
                                                 ax)
        else:
            beta_b, r, rsqr, active, maxh = _row_active_pass(
                kind, prob, beta_b, r, rsqr, active, lam0, n_scale,
                opts.randomize, key, ax, opts.opt_tol)
        maxh = host.item(maxh)
        conv = maxh < tol
        if was_full:
            stall = 0 if maxh < best else stall + 1
            best = min(best, maxh)
        done = (was_full and conv) or stall >= patience
        it += 1
    return beta_b, r, rsqr, active


def _row_lambda_max(kind, prob: RowProblem, r, rsqr, n_scale, ax: _Axes):
    c = _row_full_c(prob, r, ax)
    if kind == "sqrt":
        g = torch.abs(c) / torch.sqrt(torch.clamp_min(rsqr, 1e-30))
    else:
        g = torch.abs(c) / n_scale
    return _feat_max(torch.max(torch.where(prob.valid, g / prob.lamw,
                                           torch.zeros_like(g))), ax)


def _row_solve(kind, opts: CDOptions, prob: RowProblem, lam0, beta0_b, key,
               n_scale, ax: _Axes):
    """Warm start or the λmax → λ0 log-continuation.  ``n_scale`` is the
    true row count (padded rows carry no data)."""
    dtype = beta0_b.dtype

    def init(beta_b):
        pred = _blocks_matvec(prob.Xb, beta_b)
        if ax.feat is not None:
            pred = psum(pred, ax.feat)
        r = prob.y - pred
        rsqr = (_row_rsqr(r, ax) if kind == "sqrt"
                else torch.zeros((), dtype=dtype, device=r.device))
        return r, rsqr, torch.any(beta_b != 0, dim=1)

    if opts.warm_start:
        r, rsqr, active = init(beta0_b)
        beta_b, r, _, _ = _row_solve_at_lambda(kind, opts, prob, lam0,
                                               beta0_b, r, rsqr, active, key,
                                               n_scale, ax)
        return beta_b, r
    beta_b = torch.zeros_like(beta0_b)
    r, rsqr, active = init(beta_b)
    npdt = _np_dtype(dtype)
    lammax = npdt.type(host.item(_row_lambda_max(kind, prob, r, rsqr,
                                                 n_scale, ax)))
    lams = np.exp(np.linspace(np.log(lammax), np.log(npdt.type(lam0)),
                              opts.num_steps + 1).astype(npdt)).tolist()
    for lam in lams:
        beta_b, r, rsqr, active = _row_solve_at_lambda(
            kind, opts, prob, lam, beta_b, r, rsqr, active, key, n_scale, ax)
    return beta_b, r


class _RowSetup(NamedTuple):
    dev: torch.device
    dtype: torch.dtype
    n: int
    p: int
    ax: _Axes
    f: int                 # this rank's feature index (0 without one)
    n_local: int
    r_lo: int
    c_lo: int
    c_hi: int
    width: int             # local columns (padded)


def _check_axes(mesh, axis, feat_axis):
    names = tuple(mesh.mesh_dim_names or ())
    if feat_axis is not None:
        if feat_axis not in names:
            raise ValueError(f"feat_axis {feat_axis!r} not in mesh axes "
                             f"{names}")
        if feat_axis == axis:
            raise ValueError("feat_axis must differ from the obs axis "
                             f"({axis!r})")


def _row_setup(X, mesh, axis, feat_axis, B: int, device, kernels_opts):
    dev = rank_device(device)
    t = torch.as_tensor(X)
    n, p = t.shape
    D, o = axis_size(mesh, axis), axis_rank(mesh, axis)
    if feat_axis is not None:
        nf, f = axis_size(mesh, feat_axis), axis_rank(mesh, feat_axis)
        width, _ = _shard_chunk(p, nf, B)
        feat = mesh.get_group(feat_axis)
    else:
        nf, f, feat = 1, 0, None
        width = -(-p // B) * B
    n_local = -(-n // D)
    ax = _Axes(mesh.get_group(axis), feat, nf,
               use_kernels(kernels_opts, torch.empty(0, device=dev)))
    return _RowSetup(dev, t.dtype, n, p, ax, f, n_local, o * n_local,
                     min(f * width, p), min((f + 1) * width, p), width)


def _rows(v, su: _RowSetup, fill=0.0):
    """This rank's rows of a global ``(n,)`` vector, zero-padded."""
    v = on_device(v, su.dev, su.dtype)
    out = torch.full((su.n_local,), fill, dtype=su.dtype, device=su.dev)
    lo, hi = min(su.r_lo, su.n), min(su.r_lo + su.n_local, su.n)
    out[:hi - lo] = v[lo:hi]
    return out


def _cols(v, su: _RowSetup, fill):
    """This rank's columns of a global ``(p,)`` vector, padded with
    ``fill``."""
    out = torch.full((su.width,), fill, dtype=v.dtype, device=su.dev)
    out[:su.c_hi - su.c_lo] = v[su.c_lo:su.c_hi]
    return out


def _tile(X, su: _RowSetup):
    """This rank's ``(n_local, width)`` tile of the global design,
    zero-padded (only the tile is copied)."""
    lo, hi = min(su.r_lo, su.n), min(su.r_lo + su.n_local, su.n)
    blk = torch.as_tensor(X)[lo:hi, su.c_lo:su.c_hi].to(device=su.dev,
                                                        dtype=su.dtype)
    return torch.nn.functional.pad(
        blk, (0, su.width - blk.shape[1], 0, su.n_local - blk.shape[0]))


def _gather_out(beta_b, r, su: _RowSetup, mesh_feat_group):
    beta = beta_b.reshape(-1)
    if mesh_feat_group is not None:
        beta = all_gather(beta, mesh_feat_group).reshape(-1)
    return beta[:su.p], all_gather(r, su.ax.obs).reshape(-1)[:su.n]


def coordinate_descent_row_sharded(beta0, loss, penalty, mesh,
                                   options: CDOptions = CDOptions(), *,
                                   axis: str = "obs",
                                   feat_axis: str | None = None,
                                   seed: int = 0, key=None, device=None):
    """Observation-sharded ``coordinate_descent``: rows of ``X`` (and of
    ``y`` / the WLS weights) over ``mesh[axis]``, β replicated; with
    ``feat_axis`` the design is tiled over a 2-D mesh.  Returns ``(beta,
    residuals)`` with the full residual vector, replicated on every rank.
    ``key``: this rank's visit-order generator (default: seeded from
    ``(seed, feature rank)``); ``device`` as the feature-sharded tier."""
    if not isinstance(loss, (LeastSquaresLoss, WeightedLSLoss,
                             SqrtLassoLoss)):
        raise TypeError(
            "row-sharded CD supports LeastSquares/WeightedLS/SqrtLasso "
            f"losses; got {type(loss)!r}")
    _check_axes(mesh, axis, feat_axis)
    kind = loss.kind
    n, p = torch.as_tensor(loss.X).shape
    # zero padding would silently zero real data on a length mismatch
    if loss.y.shape[0] != n:
        raise ValueError(f"y has {loss.y.shape[0]} rows, X has {n}")
    if isinstance(loss, WeightedLSLoss) and loss.w.shape[0] != n:
        raise ValueError(f"weights have {loss.w.shape[0]} rows, X has {n}")
    if beta0.shape[0] != p:
        raise ValueError(f"beta0 has {beta0.shape[0]} coordinates, "
                         f"X has {p} columns")
    B = int(options.block_size)
    su = _row_setup(loss.X, mesh, axis, feat_axis, B, device, options)
    dev, dtype = su.dev, su.dtype
    lam0, lamw = as_l1(penalty, p, dtype, dev)
    beta0 = on_device(beta0, dev, dtype)
    if isinstance(penalty, ProxZero):
        if not options.warm_start:
            beta0 = torch.zeros_like(beta0)
        options = options.replace(warm_start=True)
    # padded rows are all-zero (x, y, w); padded columns get lamw = 1 and
    # valid = False
    w = (loss.w if isinstance(loss, WeightedLSLoss)
         else torch.ones((n,), dtype=dtype))
    nb = su.width // B
    validl = (torch.arange(su.width, device=dev) + su.c_lo < p)
    if key is None:
        key = rank_generator(seed, su.f)
    with full_f32_matmuls():
        prob = _row_build(kind, _tile(loss.X, su), _rows(loss.y, su),
                          _rows(w, su), _cols(lamw, su, 1.0).reshape(nb, B),
                          validl.reshape(nb, B), B, su.ax)
        beta_b, r = _row_solve(kind, options, prob, lam0,
                               _cols(beta0, su, 0.0).reshape(nb, B), key,
                               float(n), su.ax)
        return _gather_out(beta_b, r, su, su.ax.feat)


def _row_lasso(X, y, lam, mesh, weights, options, axis, feat_axis, seed,
               device, loss_type):
    dev = rank_device(device)
    Xt = torch.as_tensor(X)
    y = on_device(y, dev, Xt.dtype)
    g = ProxL1(float(lam), None if weights is None else
               on_device(weights, dev, Xt.dtype))
    beta0 = torch.zeros((Xt.shape[1],), dtype=Xt.dtype, device=dev)
    beta, r = coordinate_descent_row_sharded(
        beta0, loss_type(y, X), g, mesh, options, axis=axis,
        feat_axis=feat_axis, seed=seed, device=dev)
    return LassoSolution(beta, r, g, sample_std(r))


def lasso_row_sharded(X, y, lam, mesh, weights=None,
                      options: CDOptions = CDOptions(), *,
                      axis: str = "obs", seed: int = 0,
                      device=None) -> LassoSolution:
    """Observation-sharded Lasso (the large-n twin of ``lasso_sharded``)."""
    return _row_lasso(X, y, lam, mesh, weights, options, axis, None, seed,
                      device, LeastSquaresLoss)


def lasso_tile_sharded(X, y, lam, mesh, weights=None,
                       options: CDOptions = CDOptions(), *,
                       axis: str = "obs", feat_axis: str = "feature",
                       seed: int = 0, device=None) -> LassoSolution:
    """Tile-sharded Lasso on a 2-D ``(obs, feature)`` mesh: each rank holds
    an ``(n/D_obs × p/D_feat)`` tile of ``X``."""
    return _row_lasso(X, y, lam, mesh, weights, options, axis, feat_axis,
                      seed, device, LeastSquaresLoss)


def sqrt_lasso_row_sharded(X, y, lam, mesh, weights=None,
                           options: CDOptions = CDOptions(), *,
                           axis: str = "obs", seed: int = 0,
                           device=None) -> LassoSolution:
    """Observation-sharded Sqrt-Lasso."""
    return _row_lasso(X, y, lam, mesh, weights, options, axis, None, seed,
                      device, SqrtLassoLoss)


def lasso_path_row_sharded(X, y, lam_path, mesh,
                           options: CDOptions = CDOptions(), *,
                           max_hat_s: float = float("inf"),
                           standardize_X: bool = True, axis: str = "obs",
                           feat_axis: str | None = None,
                           scan_chunk: int | None = None, seed: int = 0,
                           device=None) -> LassoPath:
    """Warm-started Lasso path on the observation-sharded (or tiled)
    layout, with ``lasso_path_sharded``'s early stop; ``standardize_X``'s
    loadings are the column RMS over all rows (a psum of the local sums of
    squares).  ``scan_chunk`` is taken, checked and ignored."""
    Xt = torch.as_tensor(X)
    n, p = Xt.shape
    if np.shape(y)[0] != n:
        raise ValueError(f"y has {np.shape(y)[0]} rows, X has {n}")
    _check_axes(mesh, axis, feat_axis)
    if scan_chunk is not None and scan_chunk <= 0:
        raise ValueError("scan_chunk must be >= 1")
    B = int(options.block_size)
    su = _row_setup(X, mesh, axis, feat_axis, B, device, options)
    dev, dtype = su.dev, su.dtype
    nb = su.width // B
    lam_t = torch.as_tensor(np.asarray(lam_path)).to(dtype=dtype)
    validl = (torch.arange(su.width, device=dev) + su.c_lo < p)
    key = rank_generator(seed, su.f)
    with full_f32_matmuls():
        Xl = _tile(X, su)
        lamwl = (torch.where(validl, torch.sqrt(psum(torch.sum(Xl * Xl, 0),
                                                     su.ax.obs) / n), 1.0)
                 if standardize_X else
                 torch.ones((su.width,), dtype=dtype, device=dev))
        prob = _row_build("ls", Xl, _rows(y, su),
                          torch.ones((su.n_local,), dtype=dtype, device=dev),
                          lamwl.reshape(nb, B), validl.reshape(nb, B), B,
                          su.ax)
        del Xl
        beta_b = torch.zeros((nb, B), dtype=dtype, device=dev)
        r = prob.y
        rsqr = torch.zeros((), dtype=dtype, device=dev)
        active = torch.zeros((nb,), dtype=torch.bool, device=dev)
        stopped = False
        betas, valids = [], []
        for lam in lam_t.tolist():
            if not stopped:
                beta_b, r, rsqr, active = _row_solve_at_lambda(
                    "ls", options, prob, lam, beta_b, r, rsqr, active, key,
                    float(n), su.ax)
            valids.append(not stopped)
            if math.isfinite(max_hat_s) and not stopped:
                nnz = torch.sum(beta_b != 0)
                if su.ax.feat is not None:
                    nnz = psum(nnz, su.ax.feat)
                stopped = host.item(nnz) > max_hat_s
            betas.append(beta_b.reshape(-1))
        betas = torch.stack(betas)
        if su.ax.feat is not None:
            betas = torch.movedim(all_gather(betas, su.ax.feat), 0, 1)
            betas = betas.reshape(betas.shape[0], -1)
    k = int(np.sum(valids))
    return LassoPath(lam_t[:k].to(dev), betas[:k, :p])
