"""Judges ``group_lasso`` + ``polish_group_lasso``: each stage's
coefficients against the plain float64 working-set group solve at the
problem's λ, as ``max_j |b_j − b*_j| / max_j |b*_j|``: ``solve_err`` the
float32 group solve's, ``polish_err`` the polished ones'."""

from __future__ import annotations

import torch

from . import REFERENCE, precision, rel_err, solvers


def _solve(state, k: int, spec):
    with precision(spec) as dt:
        b, ok = solvers.group_lasso(state.X, state.Y[k],
                                    float(state.lams[k]), state.G, dtype=dt)
    if not ok and dt == torch.float64:
        raise RuntimeError(f"group lasso reference: no fixed point at "
                           f"problem {k}")
    return b


def judge(state, kept: dict) -> dict:
    out = {}
    for i, (k, stages) in kept.items():
        ref = _solve(state, k, REFERENCE)
        out[i] = {"solve_err": rel_err(stages["solve"], ref),
                  "polish_err": rel_err(stages["polish"], ref)}
    return out


def control(state, i: int, k: int, spec: dict):
    """Each stage in the precision ``spec`` names for its number."""
    return {"solve": _solve(state, k, spec["solve_err"]),
            "polish": _solve(state, k, spec["polish_err"])}
