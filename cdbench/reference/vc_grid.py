"""Judges ``locpolyl1``: the L1 coefficients at every grid point against
the plain per-point solve (``vc_solver.locpolyl1``); ``coef_err`` is
``max |b − b*| / max |b*|`` over all coefficients of all points (one
scale for the whole fit: where sin(2πz0) crosses 0 a point's own
coefficients may all be 0)."""

from __future__ import annotations

from . import REFERENCE, precision, rel_err
from .vc_solver import locpolyl1


def _solve(state, k: int, spec):
    with precision(spec) as dt:
        return locpolyl1(state.X[k], state.z[k], state.Y[k], state.grid,
                         state.degree, state.h, state.lam0, dtype=dt)


def judge(state, kept: dict) -> dict:
    return {i: {"coef_err": rel_err(out, _solve(state, k, REFERENCE))}
            for i, (k, out) in kept.items()}


def control(state, i: int, k: int, spec: dict):
    return _solve(state, k, spec["coef_err"])
