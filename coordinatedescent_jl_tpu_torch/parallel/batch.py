"""Sharded scenario batches: λ grids, evaluation grids, bandwidth sweeps
(counterpart of ``coordinatedescent_jl_tpu/parallel/batch.py``).  The
scenario axis is split over ``mesh[batch_axis]`` (each rank a contiguous
block of ``⌈L/D⌉``, as the JAX ``_pad_batch`` lays them out; the padded
tail is not solved),
the data replicated; each rank runs the port's single-device functions on
its scenarios (on the card they launch K1, K3, K4 and K5, and K1's small-n
plan in the varying-coefficient scans), and the results are all_gathered
back into the caller's order.  ``lasso_grid_sharded`` composes it with the
feature-sharded engine on a 2-D ``("batch", "feature")`` mesh.  Scenarios
are cold solves, as in the JAX module.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.varying_coefficient import (locpoly, lvocv_locpoly,
                                          lvocv_locpolyl1)
from ..ops.block_cd import (_to_blocked_beta, build_blocked,
                            full_f32_matmuls, solve_blocked)
from ..utils import host
from ..utils.helpers import on_device
from ..utils.options import CDOptions
from ._collectives import all_gather, axis_rank, axis_size, psum
from .distributed import rank_device
from .sharded_cd import (_gather_cols, _local_std, _own_vec, _setup,
                         _solve_blocked_sharded, rank_generator)


def _my_block(v, mesh, axis: str):
    """This rank's scenarios: the grid split over ``mesh[axis]`` in
    contiguous blocks of ``m = ⌈L/D⌉`` (the JAX ``_pad_batch`` layout).
    Returns ``(real scenarios of this block, m, L, the axis's group)``; the
    padded tail is never solved (its rows are dropped after the gather)."""
    v = np.asarray(v)
    D, b = axis_size(mesh, axis), axis_rank(mesh, axis)
    L = v.shape[0]
    m = -(-L // D)
    return v[b * m:min((b + 1) * m, L)], m, L, mesh.get_group(axis)


def _gather_rows(local, m: int, group, L: int):
    """``(k ≤ m, …)`` per rank, zero-padded to ``m`` rows → ``(D·m, …)`` in
    scenario order → the first ``L``."""
    if local.shape[0] < m:
        local = torch.cat([local, local.new_zeros((m - local.shape[0],)
                                                  + tuple(local.shape[1:]))])
    g = all_gather(local, group)
    return g.reshape(-1, *local.shape[1:])[:L]


def lasso_lambda_batch(X, y, lams, mesh, options: CDOptions = CDOptions(),
                       *, weights=None, batch_axis: str = "batch",
                       seed: int = 0, device=None):
    """Independent Lasso solves, one per λ, the grid split over
    ``mesh[batch_axis]`` with ``(X, y)`` replicated.  Each solve is the
    single-device engine's warm solve from zero with the generator seeded
    from ``seed``, so a point equals ``lasso`` at that λ on the same
    device.  Returns ``(len(lams), p)`` coefficients on every rank."""
    dev = rank_device(device)
    X = on_device(X, dev)
    y = on_device(y, dev, X.dtype)
    p = X.shape[1]
    lamw = (torch.ones((p,), dtype=X.dtype, device=dev) if weights is None
            else on_device(weights, dev, X.dtype))
    mine, m, L, group = _my_block(np.asarray(lams, np.float64), mesh,
                                  batch_axis)
    npdt = np.dtype(str(X.dtype).replace("torch.", "")).type
    opts = options.replace(warm_start=True)
    with full_f32_matmuls():
        prob = build_blocked("ls", opts, lamw, X=X, y=y)
        beta_b0 = _to_blocked_beta(torch.zeros((p,), dtype=X.dtype,
                                               device=dev), opts.block_size)
        betas = [solve_blocked("ls", opts, prob, float(npdt(lam)), beta_b0,
                               torch.Generator().manual_seed(seed)
                               ).beta.reshape(-1)[:p] for lam in mine]
    betas = (torch.stack(betas) if betas
             else torch.zeros((0, p), dtype=X.dtype, device=dev))
    return _gather_rows(betas, m, group, L)


def lasso_grid_sharded(X, y, lams, mesh, options: CDOptions = CDOptions(),
                       *, weights=None, standardize_X: bool = True,
                       batch_axis: str = "batch",
                       feature_axis: str = "feature", seed: int = 0,
                       device=None):
    """Independent Lasso solves over a λ grid on a 2-D ``(batch, feature)``
    mesh: the λ scenarios split over ``mesh[batch_axis]``, each solve
    feature-sharded over ``mesh[feature_axis]``.  Explicit ``weights`` win
    over ``standardize_X``.  Returns ``(len(lams), p)`` coefficients."""
    B = options.block_size
    su = _setup(X, mesh, feature_axis, B, seed, device)
    sh, dev, dtype, p, chunk = su.sh, su.dev, su.dtype, su.p, su.chunk
    y = on_device(y, dev, dtype)
    mine, m, L, group = _my_block(np.asarray(lams, np.float64), mesh,
                                  batch_axis)
    npdt = np.dtype(str(dtype).replace("torch.", "")).type
    opts = options.replace(warm_start=True)
    validl = torch.arange(chunk, device=dev) + sh.s * chunk < p
    with full_f32_matmuls():
        if weights is not None:
            lamwl = _own_vec(on_device(weights, dev, dtype), sh, chunk, 1.0)
        elif standardize_X:
            lamwl = torch.where(validl, _local_std(su), 1.0)
        else:
            lamwl = torch.ones((chunk,), dtype=dtype, device=dev)
        prob = build_blocked("ls", opts, lamwl, X=su.Xl, y=y)
        del su
        beta_b0 = torch.zeros_like(prob.lamw)
        betas = [_solve_blocked_sharded(
            "ls", opts, prob, float(npdt(lam)), beta_b0,
            rank_generator(seed, sh.s), sh).beta.reshape(-1) for lam in mine]
        betas = _gather_cols(torch.stack(betas) if betas
                             else torch.zeros((0, chunk), dtype=dtype,
                                              device=dev), sh)
    return _gather_rows(betas, m, group, L)[:, :p]


def locpoly_batch(X, z, y, zgrid, degree, kernel, mesh, *,
                  batch_axis: str = "batch", device=None):
    """``locpoly`` with the evaluation grid split over the batch axis (each
    rank's points patched by the minimum-norm solve where singular, as
    ``locpoly``).  Returns ``(p(degree+1), len(zgrid))``."""
    dev = rank_device(device)
    mine, m, L, group = _my_block(np.asarray(zgrid, np.float64).reshape(-1),
                                  mesh, batch_axis)
    q = np.shape(X)[1] * (degree + 1)
    out = (locpoly(X, z, y, mine, degree, kernel, device=dev).T
           if mine.size else
           torch.zeros((0, q), dtype=torch.as_tensor(X).dtype, device=dev))
    return _gather_rows(out.contiguous(), m, group, L).T


def lvocv_locpoly_batch(X, z, y, degree, h_arr, kernel_type, mesh, *,
                        batch_axis: str = "batch", device=None):
    """Bandwidth LOO-CV of ``locpoly`` with the bandwidths split over the
    batch axis; the scores in ``h_arr``'s order."""
    dev = rank_device(device)
    mine, m, L, group = _my_block(np.asarray(h_arr, np.float64), mesh,
                                  batch_axis)
    out = (lvocv_locpoly(X, z, y, degree, mine, kernel_type, device=dev)
           if mine.size else
           torch.zeros((0,), dtype=torch.as_tensor(X).dtype, device=dev))
    return _gather_rows(out, m, group, L)


def lvocv_locpolyl1_batch(X, z, y, degree, h_arr, kernel_type, lam0, mesh,
                          options: CDOptions = CDOptions(), *,
                          batch_axis: str = "batch", seed: int = 0,
                          cv_batch: int | None = None,
                          stats: dict | None = None, device=None):
    """Penalized-fit bandwidth LOO-CV (``lvocv_locpolyl1``) with the
    bandwidths split over the batch axis; ``cv_batch`` and the
    certified-or-fallback contract as ``lvocv_locpolyl1`` on each rank.
    ``stats`` receives ``batched_certified`` (every rank's),
    ``stall_escaped_lanes`` (0) and ``lanes_resolved_sequentially``
    (summed over the ranks).  Returns the MSE per bandwidth."""
    dev = rank_device(device)
    mine, m, L, group = _my_block(np.asarray(h_arr, np.float64), mesh,
                                  batch_axis)
    st = {"batched_certified": True, "lanes_resolved_sequentially": 0}
    mses = (lvocv_locpolyl1(X, z, y, degree, mine, kernel_type, lam0,
                            options.replace(warm_start=True), seed=seed,
                            cv_batch=cv_batch, stats=st, device=dev)
            if mine.size else
            torch.zeros((0,), dtype=torch.as_tensor(X).dtype, device=dev))
    if stats is not None:
        flags = host.tolist(psum(torch.tensor(
            [int(not st["batched_certified"]),
             st["lanes_resolved_sequentially"]], dtype=torch.int64,
            device=dev), group))
        stats["batched_certified"] = flags[0] == 0
        stats["stall_escaped_lanes"] = 0
        stats["lanes_resolved_sequentially"] = flags[1]
    return _gather_rows(mses, m, group, L)
