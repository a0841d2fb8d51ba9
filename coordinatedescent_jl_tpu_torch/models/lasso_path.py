"""Warm-started Lasso paths (counterpart of
``coordinatedescent_jl_tpu/models/lasso_path.py``): the sequential scan and
the batched execution, and the least-squares refit on the path's
supports."""

from __future__ import annotations

import math
import warnings
from typing import NamedTuple

import numpy as np
import torch

from ..ops.batched_certify import (kkt_violation_lanes, stall_escape_update,
                                   union_block_fista, union_priority)
from ..ops.block_cd import (_compact_mode, _empty_ws_cache, _init_state,
                            _path_point, _to_blocked_beta, build_blocked,
                            full_f32_matmuls)
from ..utils import host
from ..utils.helpers import (min_norm_lstsq, on_device, std_X,
                             target_device)
from ..utils.options import CDOptions, auto_batch_lanes, resolve_extrapolate


class LassoPath(NamedTuple):
    """``beta_path`` is a dense ``(num_lambda, p)`` matrix."""

    lam_path: torch.Tensor
    beta_path: torch.Tensor


def _lasso_path_core(X, y, lam_path, lamw, key, max_hat_s,
                     opts: CDOptions):
    """One warm-started sweep over ``lam_path`` (host floats).  The full
    solver state — residual, cached gradient, drift — and the working-set
    cache carry from point to point.  Returns ``(betas (L, p), valids)``;
    after the ``max_hat_s`` stop the remaining points are not solved."""
    p = X.shape[1]
    n_scale = float(y.shape[0])
    prob = build_blocked("ls", opts, lamw, X=X, y=y)
    nc = _compact_mode("ls", opts, prob, X.dtype)
    st = _init_state("ls", prob, _to_blocked_beta(
        torch.zeros((p,), dtype=X.dtype, device=X.device),
        opts.block_size), key)
    cache = _empty_ws_cache("ls", prob, nc, opts) if nc else None
    extrap = bool(nc) and resolve_extrapolate(opts, False)
    secant = (st.beta, lam_path[0], lam_path[0])
    stopped = False
    betas, valids = [], []
    for lam in lam_path:
        if not stopped:
            st, cache, secant = _path_point("ls", opts, prob, st, cache, lam,
                                            n_scale, secant, extrap)
        valids.append(not stopped)
        # the point that first exceeds max_hat_s is still recorded
        if math.isfinite(max_hat_s) and not stopped:
            stopped = host.item(torch.sum(st.beta != 0)) > max_hat_s
        betas.append(st.beta.reshape(-1)[:p])
    return torch.stack(betas), valids


def _take_cols(A, idx, C: int, fill):
    """``A[:, idx]`` with the pad slots past the first ``C`` set to ``fill``
    — the counterpart of ``jnp.take(..., mode="fill")``, gathering with
    clamped indices instead of padding ``A``."""
    g = A.index_select(1, torch.clamp_max(idx, A.shape[1] - 1))
    g[:, C:] = fill
    return g


def _refine_chunk(X, y, lamw, adiag, xnorm, lam_k, B0, frozen,
                  opts: CDOptions):
    """Batched certify/refine of one chunk of lanes (the body of the JAX
    ``refine``; its ``lax.while_loop`` is a host loop with one counted host
    read per round).  ``lam_k (k,)``, ``B0 (k, p)`` the interpolated warm
    starts, ``frozen (k,)`` lanes past the scan's ``max_hat_s`` stop.
    Returns ``(B, cert, escaped, rounds)``."""
    n, p = X.shape
    dt = X.dtype
    tol = opts.opt_tol
    n_scale = float(n)
    C = int(min(opts.compact_size, p))
    Bb = int(opts.block_size)
    Cp = -(-C // Bb) * Bb
    thrw = lamw[None, :] * (lam_k * n_scale)[:, None]
    R = y[None, :] - torch.matmul(B0, X.T)

    def certify(B, R):
        return kkt_violation_lanes(B, R, thrw, X, adiag, xnorm)

    H = certify(B0, R)
    mx = torch.amax(H, dim=1)
    cert = (mx < tol) | frozen
    # f32 lanes can limit-cycle a hair above tol: the per-lane stall escape
    # (f64 keeps the strict rule)
    patience = (opts.stall_patience if dt.itemsize < 8
                else np.iinfo(np.int32).max)
    best = mx
    stall = torch.zeros(mx.shape, dtype=torch.int32, device=X.device)
    esc = torch.zeros(mx.shape, dtype=torch.bool, device=X.device)
    B = B0
    big = torch.finfo(dt).max / 8
    zero = torch.zeros((), dtype=dt, device=X.device)
    rounds = 0
    while (rounds < 2 * opts.compact_rounds
           and not host.item(torch.all(cert))):
        with host.span("path.refine_round"):
            hi = 2.0 * torch.amax(torch.where(cert[:, None], zero, H)) + 1.0
            pri = union_priority(B, H, cert, hi)
            # lax.top_k breaks ties toward the lower index; so does the
            # first C of a stable descending sort (many columns have
            # priority 0).  The mark counts, later, the columns the union
            # wants: a support column of an uncertified lane, or a
            # violation above the noise floor
            with host.mark("union", later=pri, cap=C):
                top = torch.sort(pri, descending=True, stable=True)[1][:C]
            idx = torch.sort(top)[0]
            if Cp != C:   # pad slots: zero columns, pinned at zero below
                idx = torch.cat([idx, torch.full((Cp - C,), p,
                                                 dtype=idx.dtype,
                                                 device=idx.device)])
            Xs = _take_cols(X, idx, C, 0.0)                      # (n, Cp)
            Ks = torch.matmul(Xs.T, Xs)                          # (Cp, Cp)
            Bs0 = _take_cols(B, idx, C, 0.0)
            thr_full = _take_cols(thrw, idx, C, big)
            cs0 = torch.matmul(R, Xs)                            # Xs'R
            with host.span("path.union_block_fista"):
                bs = union_block_fista(Ks, thr_full, Bs0, cs0, cert, opts)
            R = R - torch.matmul(bs - Bs0, Xs.T)
            B = B.clone()
            B[:, idx[:C]] = bs[:, :C]
            H = certify(B, R)
            mx = torch.amax(H, dim=1)
            cert, best, stall, esc = stall_escape_update(
                cert, best, stall, esc, mx, patience, tol, frozen)
        rounds += 1
    return B, cert, esc, rounds


@host.spanned("path.batched")
def _lasso_path_batched_core(X, y, lam_t, lamw, key, max_hat_s,
                             opts: CDOptions, stride: int, batch: int):
    """Batched λ path: a coarse sequential scan over every ``stride``-th
    point (and the last), then the other points refined in chunks of
    ``batch`` lanes from warm starts interpolated between the bracketing
    coarse solutions (see the JAX ``_lasso_path_batched_core`` for the
    scheme and why it is sound).  ``lax.map`` over chunks is a host loop;
    a chunk is not padded to ``batch`` lanes (the JAX padding lanes are
    frozen and change nothing).

    Returns ``(betas (L, p), valids (L,) bool, all_cert, n_escaped,
    rounds)``, ``rounds`` the refine rounds of all chunks; ``all_cert`` is
    False when some refined lane exhausted its round budget uncertified —
    the caller must then fall back to the scan."""
    n, p = X.shape
    g = lam_t.shape[0]
    dev = X.device
    cidx = np.arange(0, g, stride)
    if cidx[-1] != g - 1:
        cidx = np.append(cidx, g - 1)
    rest = np.setdiff1d(np.arange(g), cidx)
    lam_dev = lam_t.to(dev)
    with host.span("path.coarse_scan"):
        betas_c, valids_c = _lasso_path_core(X, y, lam_t[cidx].tolist(),
                                             lamw, key, max_hat_s, opts)
    valids_c = torch.tensor(valids_c, device=dev)
    if rest.size:
        # one read of X, no (n, p) temporary
        adiag = torch.clamp_min(torch.linalg.vector_norm(X, dim=0).square(),
                                1e-30)
        xnorm = torch.sqrt(adiag)
        seg = np.searchsorted(cidx, rest) - 1
        lam_lo = lam_dev[cidx[seg]]
        lam_hi = lam_dev[cidx[seg + 1]]
        lam_r = lam_dev[rest]
        denom = torch.where(lam_hi != lam_lo, lam_hi - lam_lo,
                            torch.ones_like(lam_hi))
        a = torch.clamp((lam_r - lam_lo) / denom, 0.0, 1.0)
        seg_t = torch.as_tensor(seg, device=dev)
        starts = ((1.0 - a)[:, None] * betas_c[seg_t]
                  + a[:, None] * betas_c[seg_t + 1])
        # lanes past the coarse scan's max_hat_s stop have stale anchors:
        # frozen, and truncated by the prefix rule below
        frozen = ~(valids_c[seg_t] & valids_c[seg_t + 1])
        k = min(batch, int(rest.size))
        parts = []
        for i in range(0, int(rest.size), k):
            with host.span("path.refine"):
                parts.append(_refine_chunk(X, y, lamw, adiag, xnorm,
                                           lam_r[i:i + k], starts[i:i + k],
                                           frozen[i:i + k], opts))
        refined = torch.cat([part[0] for part in parts])
        certs = torch.cat([part[1] for part in parts])
        escs = torch.cat([part[2] for part in parts])
        rounds = sum(part[3] for part in parts)
        all_cert = host.item(torch.all(certs | frozen))
        n_escaped = host.item(torch.sum(escs.to(torch.int32)))
        betas = torch.zeros((g, p), dtype=X.dtype, device=dev)
        betas[torch.as_tensor(cidx, device=dev)] = betas_c
        betas[torch.as_tensor(rest, device=dev)] = refined
    else:
        betas, all_cert, n_escaped, rounds = betas_c, True, 0, 0
    # reference early-stop semantics: the first point whose support exceeds
    # max_hat_s is still recorded, later points are dropped
    exceed = host.tolist(torch.sum(betas != 0, dim=1) > max_hat_s)
    valids = np.concatenate([[True], np.cumsum(exceed)[:-1] == 0])
    return betas, valids, all_cert, n_escaped, rounds


@host.spanned("est.lasso_path")
def lasso_path(X, y, lam_path, options: CDOptions = CDOptions(), *,
               max_hat_s: float = math.inf, standardize_X: bool = True,
               path_batch: int | None = None,
               coarse_stride: int | None = None,
               scan_chunk: int | None = None, seed: int = 0,
               stats: dict | None = None, device=None) -> LassoPath:
    """Solve the Lasso along a **decreasing** λ grid with warm starts.

    With ``standardize_X`` the penalty weights are the column RMS loadings.
    The path is truncated after the first point whose support size
    exceeds ``max_hat_s`` (that point is kept).  Runs on ``device``
    (``None``: the GPU, raising when there is none; ``"cpu"`` for the
    plain path on the CPU), where the inputs are moved.

    ``path_batch > 0`` runs the batched execution: only every
    ``coarse_stride``-th point (default ``len(lam_path) − 1``: the
    endpoints) runs the sequential scan, and the other points are refined
    in chunks of ``path_batch`` lanes.  ``path_batch=None`` resolves to 128
    lanes for sub-f64 CUDA tensors on grids of 16 or more points, else 0
    (the scan).  Grids no longer than ``max(2, coarse_stride)`` take the
    scan.  A batched run that does not certify every point warns
    (``RuntimeWarning``) and returns the scan's result.

    ``scan_chunk`` is taken for the JAX package's interface, checked
    (``>= 1``) and otherwise ignored: there it cuts the scan into device
    programs of that many λ points with the carry handed on by the host,
    for a runtime that bounds one program's time; here the scan is a host
    loop of short kernels already, the ``max_hat_s`` stop is in it, and
    the result is the same bit for bit with or without the option.  The
    JAX package's segment loop behind it
    (``ops/batched_certify.py::run_chunked_segments``, called at
    ``models/lasso_path.py:321-327`` there) went with ``scan_chunk`` and
    has no counterpart here.

    ``stats``, if a dict, receives ``used_batched``, ``batched_certified``
    and ``stall_escaped_lanes`` (as in the JAX package), and
    ``refine_rounds``, the batched execution's certify/refine rounds.
    """
    dev = target_device(device)
    X = on_device(X, dev)
    y = on_device(y, dev, X.dtype)
    lam_t = torch.as_tensor(lam_path).to(dtype=X.dtype)
    L = int(lam_t.shape[0])
    if path_batch is None:
        path_batch = auto_batch_lanes(X.dtype, dev, L, min_points=16)
    if coarse_stride is None:
        coarse_stride = max(1, L - 1)
    if coarse_stride < 1:
        raise ValueError("coarse_stride must be >= 1")
    if path_batch < 0:
        raise ValueError("path_batch must be >= 0")
    if scan_chunk is not None and scan_chunk <= 0:
        raise ValueError("scan_chunk must be >= 1")
    key = torch.Generator().manual_seed(seed)
    batched_ok = used_batched = False
    n_escaped = rounds = 0
    with full_f32_matmuls():
        lamw = (std_X(X) if standardize_X
                else torch.ones((X.shape[1],), dtype=X.dtype, device=dev))
        if path_batch and L > max(2, coarse_stride):
            used_batched = True
            betas, valids, all_cert, n_esc, rounds = _lasso_path_batched_core(
                X, y, lam_t, lamw, key, float(max_hat_s), options,
                int(coarse_stride), int(path_batch))
            batched_ok = bool(all_cert)
            n_escaped = int(n_esc) if batched_ok else 0
            if not batched_ok:
                # a refined lane exhausted its round budget uncertified:
                # discard and take the scan (the reference's semantics)
                warnings.warn(
                    "lasso_path(path_batch=...): batched refinement did not "
                    "certify every point; falling back to the sequential "
                    "scan (consider a larger options.compact_size or a "
                    "smaller path_batch)", RuntimeWarning)
        if not batched_ok:
            with host.span("path.scan"):
                betas, valids = _lasso_path_core(X, y, lam_t.tolist(), lamw,
                                                 key, float(max_hat_s),
                                                 options)
    if stats is not None:
        stats["used_batched"] = used_batched
        stats["batched_certified"] = batched_ok
        stats["stall_escaped_lanes"] = n_escaped
        stats["refine_rounds"] = rounds
    k = int(np.sum(valids))
    return LassoPath(lam_t[:k].to(dev), betas[:k])


def refit_lasso_path(path: LassoPath, X, y, *, device=None) -> dict:
    """Least-squares refit on each distinct support along the path: a dict
    from the support (a tuple of 0-based indices) to the OLS coefficients
    ``X[:, S] \\ y``, tensors on ``device`` (``None``: the GPU, raising
    when there is none; ``"cpu"`` for the CPU).  The supports come to the
    host in one counted read; each refit gathers ``X[:, S]`` and solves on
    the device for the minimum-norm solution
    (``utils.helpers.min_norm_lstsq``), as ``numpy.linalg.lstsq`` gives in
    the JAX package, also when ``X[:, S]`` is rank-deficient."""
    dev = target_device(device)
    X = on_device(X, dev)
    y = on_device(y, dev, X.dtype)
    beta_path = on_device(path.beta_path, dev)
    rows, cols = host.numpy(torch.nonzero(beta_path).T)
    out = {}
    for i in range(beta_path.shape[0]):
        S = tuple(cols[rows == i].tolist())
        if S in out:
            continue
        if len(S) == 0:
            out[S] = torch.zeros((0,), dtype=X.dtype, device=dev)
        else:
            idx = torch.as_tensor(S, dtype=torch.int64, device=dev)
            out[S] = min_norm_lstsq(X.index_select(1, idx), y)
    return out
