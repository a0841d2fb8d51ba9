"""Feature-sharded group-coordinate descent (counterpart of
``coordinatedescent_jl_tpu/parallel/sharded_group.py``): whole groups
partitioned over ``mesh[axis]``, ``y`` and the residual replicated, exact
group-block CD within a shard (the port's ``_group_active_pass``, as in
``ops/group_cd.py``: the group pass kernel on the card), block-Jacobi
across shards merged by one residual psum, the step safeguarded (``t = 1``
against ``t = 1/D`` on the global group-lasso objective) with the exact
group-sparsity snap, and convergence declared by the group-KKT full sweep
(K5 on the card) with its certificate max-reduced.  Host control flow as in ``sharded_cd.py``;
``_pmax_scalar``'s all_gather workaround is dropped there too.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..models.lasso import LassoSolution
from ..ops.block_cd import _blocks_matvec, _np_dtype, full_f32_matmuls
from ..ops.group_cd import (GroupState, _block_width, _build_group_problem,
                            _group_active_pass, _group_full_check,
                            _group_lambda_max)
from ..ops.losses import LeastSquaresLoss, WeightedLSLoss
from ..ops.prox import ProxL1Group, fista_momentum
from ..utils import host
from ..utils.helpers import on_device, sample_std
from ..utils.options import CDOptions, use_kernels
from ._collectives import pmax, psum
from .distributed import rank_device
from .sharded_cd import (Shard, _design_info, _gather_cols, _own_columns,
                         _own_vec, make_shard, rank_generator)


def _group_norms(beta, k: int, G: int):
    """Per-group ℓ2 norms of a (nb, k·G) blocked iterate → (nb, k)."""
    bg = beta.reshape(beta.shape[0], k, G)
    return torch.sqrt(torch.sum(bg * bg, dim=2))


def _sharded_group_active_pass(prob, st: GroupState, lam0, n_scale,
                               randomize, coefs, kernels: bool, sh: Shard, w,
                               opt_tol):
    """One concurrent pass: exact sequential group-block CD within each
    shard against the replicated residual (the group pass kernel when
    ``kernels``), block-Jacobi across shards, one residual psum + objective
    safeguard + exact group-zero snap."""
    r0, beta0 = st.r, st.beta
    st2, maxh = _group_active_pass(prob, st, lam0, n_scale, randomize, coefs,
                                   kernels)
    dbeta = st2.beta - beta0
    dr = psum(st2.r - r0, sh.group)
    maxh = pmax(maxh, sh.group)
    nb, B = prob.valid.shape
    k = prob.lamw.shape[1]
    G = B // k
    if sh.D > 1:
        one = torch.ones((), dtype=r0.dtype, device=r0.device)
        ts = (one, one / sh.D)
        pens = lam0 * psum(torch.stack([
            torch.sum(prob.lamw * _group_norms(beta0 + t * dbeta, k, G))
            for t in ts]), sh.group)

        def objective(i):
            r = r0 + ts[i] * dr
            rw = r if w is None else w * r
            return torch.dot(rw, r) / (2.0 * n_scale) + pens[i]

        t = torch.where(objective(0) <= objective(1), ts[0], ts[1])
        r_new, beta_new = r0 + t * dr, beta0 + t * dbeta
        # exact group-sparsity snap of the damped merge's dust
        prop_zero = _group_norms(st2.beta, k, G) == 0
        dust = _group_norms(beta_new, k, G) <= opt_tol
        snap = torch.repeat_interleave(prop_zero & dust, G, dim=1)
        delta = torch.where(snap, beta_new, torch.zeros_like(beta_new))
        beta_new = beta_new - delta
        corr = (_blocks_matvec(prob.Xb, delta)
                if host.item(torch.any(delta != 0))
                else torch.zeros_like(r_new))
        r_new = r_new + psum(corr, sh.group)
    else:
        r_new, beta_new = r0 + dr, beta0 + dbeta
    return st2._replace(r=r_new, beta=beta_new,
                        active=torch.any(beta_new != 0, dim=1)), maxh


def _sharded_group_solve_at_lambda(opts: CDOptions, prob, lam0,
                                   st: GroupState, n_scale, coefs,
                                   kernels: bool, sh: Shard, w) -> GroupState:
    """Epoch loop: max-reduced group-KKT sweeps alternating with concurrent
    active passes until two consecutive converged passes; the f32 stall
    detector on full checks."""
    dtype = st.beta.dtype
    tol = float(_np_dtype(dtype).type(opts.opt_tol))
    patience = (opts.stall_patience if dtype.itemsize < 8
                else np.iinfo(np.int32).max)
    st = st._replace(it=0, conv=True, done=False)
    best = math.inf
    stall = 0
    while not st.done and st.it < opts.max_iter:
        host.COUNTS["epochs"] += 1
        was_full = st.conv
        if was_full:
            s2, maxh = _group_full_check(prob, st, lam0, n_scale,
                                         opts.opt_tol, kernels)
            maxh = pmax(maxh, sh.group)
        else:
            s2, maxh = _sharded_group_active_pass(
                prob, st, lam0, n_scale, opts.randomize, coefs, kernels, sh,
                w, opts.opt_tol)
        maxh = host.item(maxh)
        conv = maxh < tol
        if was_full:
            stall = 0 if maxh < best else stall + 1
            best = min(best, maxh)
        done = (was_full and conv) or stall >= patience
        st = s2._replace(it=st.it + 1, conv=conv, done=done)
    return st


def group_coordinate_descent_sharded(beta0, loss, penalty: ProxL1Group,
                                     mesh, options: CDOptions = CDOptions(),
                                     *, axis: str = "feature", seed: int = 0,
                                     key=None, device=None):
    """Feature-sharded group-coordinate descent (LS and weighted-LS losses):
    whole groups partitioned over ``mesh[axis]`` (a shard holds
    ``⌈ng/(D·k)⌉·k`` groups, ``k`` groups a block; groups never span
    shards).  Returns ``(beta, r)``, replicated on every rank; ``device``
    as ``coordinate_descent_sharded``."""
    if isinstance(loss, WeightedLSLoss):
        weighted = True
    elif isinstance(loss, LeastSquaresLoss):
        weighted = False
    else:
        raise TypeError("sharded group penalty supports the least-squares "
                        "and weighted-LS losses")
    G = int(penalty.group_size)
    if G < 1:
        raise ValueError("group_size must be ≥ 1")
    dev = rank_device(device)
    sh = make_shard(mesh, axis, seed)
    n, p, dtype = _design_info(loss.X)
    ng = -(-p // G)
    lamw_g = (torch.ones((ng,), dtype=dtype, device=dev)
              if penalty.weights is None
              else on_device(penalty.weights, dev, dtype))
    if tuple(lamw_g.shape) != (ng,):
        raise ValueError(f"group weight vector has shape "
                         f"{tuple(lamw_g.shape)}, expected ({ng},)")
    beta0 = on_device(beta0, dev, dtype)
    if tuple(beta0.shape) != (p,):
        raise ValueError("dimension mismatch between beta0 and loss")
    # the shard width: whole blocks of k groups, the group count padded at
    # the global tail
    B = _block_width(G)
    k = B // G
    ng_shard = -(-ng // (sh.D * k)) * k
    chunk = ng_shard * G
    Xl = _own_columns(loss.X, sh, p, chunk, dev, dtype)
    y = on_device(loss.y, dev, dtype)
    w = on_device(loss.w, dev, dtype) if weighted else None
    lam0 = float(_np_dtype(dtype).type(float(penalty.lam0)))
    if key is None:
        key = rank_generator(seed, sh.s)
    kernels = use_kernels(options, Xl)
    coefs = fista_momentum(options.block_iters, dtype)
    n_scale = float(n)
    with full_f32_matmuls():
        prob = _build_group_problem(Xl, y, _own_vec(lamw_g, sh, ng_shard,
                                                    1.0), G, w)
        del Xl
        nb = prob.valid.shape[0]
        beta_g = _own_vec(beta0, sh, chunk, 0.0).reshape(nb, B)
        r = prob.y - psum(_blocks_matvec(prob.Xb, beta_g), sh.group)
        st = GroupState(beta=beta_g, r=r,
                        active=torch.any(beta_g != 0, dim=1), key=key, it=0,
                        conv=True, done=False)
        if options.warm_start:
            st = _sharded_group_solve_at_lambda(options, prob, lam0, st,
                                                n_scale, coefs, kernels, sh,
                                                w)
        else:
            npdt = _np_dtype(dtype)
            lammax = npdt.type(host.item(pmax(_group_lambda_max(
                prob, st, n_scale, kernels), sh.group)))
            lams = np.exp(np.linspace(np.log(lammax), np.log(npdt.type(lam0)),
                                      options.num_steps + 1)
                          .astype(npdt)).tolist()
            for lam in lams:
                st = _sharded_group_solve_at_lambda(options, prob, lam, st,
                                                    n_scale, coefs, kernels,
                                                    sh, w)
        beta = _gather_cols(st.beta.reshape(-1), sh)[:p]
    return beta, st.r


def group_lasso_sharded(X, y, lam, group_size: int, mesh, weights=None,
                        options: CDOptions = CDOptions(), *,
                        axis: str = "feature", seed: int = 0,
                        device=None) -> LassoSolution:
    """Feature-sharded Group Lasso over consecutive equal-size groups;
    returns a ``LassoSolution`` (replicated on every rank)."""
    dev = rank_device(device)
    _, p, dtype = _design_info(X)
    y = on_device(y, dev, dtype)
    g = ProxL1Group(float(lam), int(group_size),
                    None if weights is None else on_device(weights, dev,
                                                           dtype))
    beta0 = torch.zeros((p,), dtype=dtype, device=dev)
    beta, r = group_coordinate_descent_sharded(
        beta0, LeastSquaresLoss(y, X), g, mesh, options, axis=axis,
        seed=seed, device=dev)
    return LassoSolution(beta, r, g, sample_std(r))
