"""Judges ``lasso_path_wide``: ``lasso_path``'s comparison (the same
points of each kept path, the same ``coef_err``) against a working-set
solve that suits a design with far more columns than rows.

``solvers.lasso`` keeps every column that ever joined its working set and
lets the set double each round.  At p ≫ n and a small λ the set passes n
columns, its Gram turns singular, the restricted solve stops at its
iteration cap short of the optimum, the inexact residual shows violators,
and the set grows without end (past 46,000 columns at n = 1,000, p = 1M,
λ = 0.05·λmax, whose float64 Gram did not fit on the card).  Here the
working set is the current solution's support and at most ``_GROW`` new
violators a round: it stays near the support, which a Lasso solution in
general position keeps under n, so ``solvers.gram_lasso`` solves it to its
fixed point and exactly on its support.  A column that leaves the set
meets its optimality condition at the restricted optimum, and each round's
optimum lowers the objective, so the loop ends when no column violates.
Plain PyTorch; no import of the port or of the JAX package.
"""

from __future__ import annotations

import torch

from . import REFERENCE, precision, rel_err, solvers
from .lasso_path import points

_GROW = 128          # violators a round may add
_MAX_ROUNDS = 200


def lasso(X, y, lam: float, *, dtype=torch.float64, b0=None):
    """``argmin ‖y − Xb‖²/2 + n·λ·‖b‖₁`` in ``dtype`` from the warm start
    ``b0`` (a previous λ's solution, or zero); returns ``(b (p,),
    converged)``."""
    n, p = X.shape
    yd = y.to(dtype)
    thr = n * float(lam)
    _, slack = solvers._tols(dtype)
    beta = (torch.zeros((p,), dtype=dtype, device=X.device) if b0 is None
            else b0.to(dtype))
    ws = torch.nonzero(beta).reshape(-1)
    r = yd - X[:, ws].to(dtype) @ beta[ws]
    for rnd in range(_MAX_ROUNDS):
        viol = torch.abs(solvers.xtr(X, r)) - thr
        viol[ws] = -1.0
        cand = torch.nonzero(viol > slack * thr).reshape(-1)
        if cand.numel() == 0 and (rnd or ws.numel() == 0):
            return beta, True
        if cand.numel():
            k = min(cand.numel(), _GROW)
            ws = torch.cat([ws, cand[torch.topk(viol[cand], k).indices]])
        Xs = X[:, ws].to(dtype)
        c = Xs.T @ yd
        b = solvers.gram_lasso((Xs.T @ Xs)[None], c[None],
                               torch.full_like(c, thr)[None],
                               beta[ws][None])[0]
        beta = torch.zeros_like(beta)
        beta[ws] = b
        r = yd - Xs @ b
        ws = ws[b != 0]
    return beta, False


def _solve_points(state, k: int, pts, spec):
    with precision(spec) as dt:
        sols, b = {}, None
        for j in pts:
            b, ok = lasso(state.X, state.Y[k], float(state.lams[k, j]),
                          dtype=dt, b0=b)
            if not ok and dt == torch.float64:
                raise RuntimeError(f"lasso_path_wide reference: no fixed "
                                   f"point at problem {k}, point {j}")
            sols[j] = b
    return sols


def judge(state, kept: dict) -> dict:
    out = {}
    for i, (k, beta_path) in kept.items():
        pts = points(state, i)
        ref = _solve_points(state, k, pts, REFERENCE)
        if beta_path.shape[0] != state.lams.shape[1]:
            out[i] = {"coef_err": float("inf")}
            continue
        out[i] = {"coef_err": max(rel_err(beta_path[j], ref[j])
                                  for j in pts)}
    return out


def control(state, i: int, k: int, spec: dict):
    """The reference in the program's place at ``spec``'s precision: the
    judged points of the path filled, the others NaN."""
    pts = points(state, i)
    sols = _solve_points(state, k, pts, spec["coef_err"])
    L, p = state.lams.shape[1], state.X.shape[1]
    path = torch.full((L, p), float("nan"), dtype=torch.float64,
                      device=state.X.device)
    for j in pts:
        path[j] = sols[j].to(torch.float64)
    return path
