"""Judges ``lasso_path``: at ``check.points`` points of each kept path
(the smallest λ, where the support is largest, and others drawn from the
seed), the coefficients against the plain working-set solve at that λ;
``coef_err`` is the largest ``max_j |b_j − b*_j| / max_j |b*_j|`` of a
problem's points."""

from __future__ import annotations

import numpy as np
import torch

from .. import data
from . import REFERENCE, precision, rel_err, solvers


def points(state, i: int) -> list[int]:
    """The path points judged for window problem ``i``, in path order."""
    L = state.lams.shape[1]
    k = int(state.traffic["check"]["points"])
    rng = np.random.default_rng(data.subseed(state.seed, 1000 + i))
    pick = rng.choice(L - 1, size=min(k - 1, L - 1), replace=False)
    return sorted({int(j) for j in pick} | {L - 1})


def _solve_points(state, k: int, pts, spec):
    with precision(spec) as dt:
        sols, units = {}, None
        for j in pts:
            b, ok, units = solvers.lasso(state.X, state.Y[k],
                                         float(state.lams[k, j]), dtype=dt,
                                         units=units)
            if not ok and dt == torch.float64:
                raise RuntimeError(f"lasso reference: no fixed point at "
                                   f"problem {k}, point {j}")
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
