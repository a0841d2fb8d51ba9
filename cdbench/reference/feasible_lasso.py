"""Judges ``feasible_lasso`` + ``polish_feasible_lasso`` against the
float64 loading fixed point: the pair (b*, Γ*) with b* the weighted Lasso
``argmin ‖y − Xb‖²/2 + n·λ0·Σ_j Γ*_j |b_j|`` and ``Γ*_j = sqrt(mean_i
(X_ij r_i)²)`` at its residuals ``r = y − X b*``.

The fixed point is iterated from the reference's own start, the column
RMS loadings (the loadings of a unit residual), not from anything the
program returned: a weighted Lasso at the current loadings, then the
loadings of its residuals, until ``max|ΔΓ| / maxΓ ≤ 1e-12``.  Each
weighted Lasso is a working set warm-started at the previous support:
``solvers.gram_lasso`` on the support plus at most ``_GROW`` violators a
round, then one ``X'r`` over every column, until none violates its
threshold ``n·λ0·Γ_j``.  The design is widened to the reference's
precision a block of columns at a time (``solvers.xtr``'s bound): no
design-sized float64 copy.

Compared, each as ``max_j |b_j − b*_j| / max_j |b*_j|``:

- ``polish_err``: the polished coefficients against b*;
- ``loadings_err``: the polish's loadings against Γ*;
- ``solve_err``: the float32 stage's coefficients against the float64
  weighted Lasso at the loadings that stage returned (its outer loop stops
  at a relative loading change of 1e-2, so these are one update past the
  loadings it solved at).

Plain PyTorch; no import of the port or of the JAX package.
"""

from __future__ import annotations

import torch

from . import REFERENCE, precision, rel_err, solvers

_GROW = 128           # violators a working-set round may add
_MAX_ROUNDS = 200     # working-set rounds of one weighted Lasso
_MAX_POINT = 100      # loading rounds of the fixed point
_POINT_TOL = {torch.float64: 1e-12, torch.float32: 1e-6}


def loadings(X, r):
    """``sqrt(mean_i (X_ij r_i)²)`` for every column, in ``r``'s precision,
    X widened to it ``solvers._COLS`` columns at a time."""
    n, p = X.shape
    rr = r * r
    return torch.sqrt(torch.cat([
        rr @ X[:, j:j + solvers._COLS].to(r.dtype).square()
        for j in range(0, p, solvers._COLS)]) / n)


def weighted_lasso(X, y, lam0: float, gam, *, b0=None):
    """``argmin ‖y − Xb‖²/2 + n·λ0·Σ_j Γ_j |b_j|`` in ``gam``'s precision
    from the warm start ``b0``; returns ``(b (p,), converged)``."""
    n, p = X.shape
    dt = gam.dtype
    yd = y.to(dt)
    thr = n * float(lam0) * gam
    _, slack = solvers._tols(dt)
    beta = (torch.zeros((p,), dtype=dt, device=X.device) if b0 is None
            else b0.to(dt))
    ws = torch.nonzero(beta).reshape(-1)
    r = yd - X[:, ws].to(dt) @ beta[ws]
    for rnd in range(_MAX_ROUNDS):
        viol = torch.abs(solvers.xtr(X, r)) - thr
        viol[ws] = -1.0
        cand = torch.nonzero(viol > slack * thr).reshape(-1)
        if cand.numel() == 0 and (rnd or ws.numel() == 0):
            return beta, True
        if cand.numel():
            k = min(cand.numel(), _GROW)
            ws = torch.cat([ws, cand[torch.topk(viol[cand] / thr[cand],
                                                k).indices]])
        Xs = X[:, ws].to(dt)
        c = Xs.T @ yd
        b = solvers.gram_lasso((Xs.T @ Xs)[None], c[None], thr[ws][None],
                               beta[ws][None])[0]
        beta = torch.zeros_like(beta)
        beta[ws] = b
        r = yd - Xs @ b
        ws = ws[b != 0]
    return beta, False


def fixed_point(X, y, lam0: float, dtype):
    """The loading fixed point ``(b, Γ, converged)`` in ``dtype``, from
    the column RMS loadings."""
    yd = y.to(dtype)
    gam = loadings(X, torch.ones_like(yd))
    b = None
    for _ in range(_MAX_POINT):
        b, ok = weighted_lasso(X, yd, lam0, gam, b0=b)
        sup = torch.nonzero(b).reshape(-1)
        new = loadings(X, yd - X[:, sup].to(dtype) @ b[sup])
        change = float(torch.amax(torch.abs(new - gam)) / torch.amax(new))
        gam = new
        if ok and change <= _POINT_TOL[dtype]:
            return b, gam, True
    return b, gam, False


def _point(state, k: int, spec):
    with precision(spec) as dt:
        b, gam, ok = fixed_point(state.X, state.Y[k], state.lam0, dt)
    if not ok and dt == torch.float64:
        raise RuntimeError(f"feasible lasso reference: no loading fixed "
                           f"point at problem {k}")
    return b, gam


def _at(state, k: int, gam, spec):
    """The weighted Lasso at the loadings ``gam``, in ``spec``'s
    precision."""
    with precision(spec) as dt:
        b, ok = weighted_lasso(state.X, state.Y[k], state.lam0,
                               torch.as_tensor(gam).to(state.X.device, dt))
    if not ok and dt == torch.float64:
        raise RuntimeError(f"feasible lasso reference: no weighted Lasso "
                           f"optimum at problem {k}")
    return b


def judge(state, kept: dict) -> dict:
    out = {}
    for i, (k, o) in kept.items():
        b, gam = _point(state, k, REFERENCE)
        b_solve = _at(state, k, o["solve_loadings"], REFERENCE)
        out[i] = {"solve_err": rel_err(o["solve"], b_solve),
                  "polish_err": rel_err(o["polish"], b),
                  "loadings_err": rel_err(o["loadings"], gam)}
    return out


def control(state, i: int, k: int, spec: dict):
    """The fixed point in the precision ``spec`` names for ``polish_err``
    and ``loadings_err`` (one fixed point gives both: they must name the
    same); the float32 stage as the weighted Lasso in ``solve_err``'s
    precision at that fixed point's loadings."""
    if spec["loadings_err"] != spec["polish_err"]:
        raise ValueError("feasible lasso control: polish_err and "
                         "loadings_err must name one precision")
    b, gam = _point(state, k, spec["polish_err"])
    return {"solve": _at(state, k, gam, spec["solve_err"]),
            "solve_loadings": gam, "polish": b, "loadings": gam}
