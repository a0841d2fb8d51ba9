"""One problem = ``feasible_lasso`` (the Lasso with penalty loadings
re-estimated from its residuals) at λ0 = sqrt(2 ln p / n) for a fresh
heteroscedastic response, with the traffic's outer (``outer``) and inner
(``options``) options, then ``polish_feasible_lasso`` of its solution to
the float64 (β, Γ) fixed point: relative duality gap ``target_rel_gap``
and loading change ``gamma_rtol``.  Certified when the polish converged.
Judged: the float32 stage's coefficients with the loadings it returned,
and the polished coefficients and loadings."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

import coordinatedescent_jl_tpu_torch as tcd

from .. import data
from . import Outcome

# the responses' own random stream (data.py's are 0-3 and 5)
_STREAM = 6


class State(NamedTuple):
    X: torch.Tensor
    Y: torch.Tensor         # (pool + 1, n)
    lam0: float
    opts: object            # IterLassoOptions
    traffic: dict
    seed: int
    pool: int


def lam0_of(n: int, p: int) -> float:
    """Upstream ``cd_bench.jl``'s level ``sqrt(2 ln p / n)``."""
    return math.sqrt(2.0 * math.log(p) / n)


def hetero_responses(X, m: int, s: int, seed: int):
    """``m`` responses ``(m, n)``: ``f = Xθ`` with ``s`` planted
    coordinates drawn without replacement and N(0, 1) values, then ``y_i =
    f_i + σ_i ε_i`` with ``σ_i = sqrt((1 + f_i)² / mean_i (1 + f_i)²)``
    and ``ε_i ~ N(0, 1)``: noise of mean variance 1 that grows with the
    signal (Belloni, Chernozhukov & Hansen 2014's heteroscedastic
    design)."""
    n, p = X.shape
    dev = X.device
    g = data.generator(seed, _STREAM, dev)
    Y = torch.empty((m, n), dtype=X.dtype, device=dev)
    for a in range(0, m, data._CHUNK):
        k = min(data._CHUNK, m - a)
        sup = torch.topk(torch.rand((k, p), generator=g, device=dev), s,
                         dim=1).indices
        Bt = torch.zeros((k, p), dtype=X.dtype, device=dev)
        Bt.scatter_(1, sup, torch.randn((k, s), generator=g, device=dev,
                                        dtype=X.dtype))
        F = Bt @ X.T
        v = torch.square(1.0 + F)
        sd = torch.sqrt(v / torch.mean(v, dim=1, keepdim=True))
        Y[a:a + k] = F + sd * torch.randn((k, n), generator=g, device=dev,
                                          dtype=X.dtype)
    return Y


def prepare(cfg, traffic, seed, dev) -> State:
    X = data.gauss_design(cfg, seed, dev)
    pool = int(traffic["pool"])
    Y = hetero_responses(X, pool + 1, cfg["planted"], seed)
    opts = tcd.IterLassoOptions(
        **traffic["outer"], options_cd=tcd.CDOptions(**traffic["options"]))
    return State(X, Y, lam0_of(*X.shape), opts, traffic, seed, pool)


def solve(state: State, k: int, span) -> Outcome:
    X, y, tr = state.X, state.Y[k], state.traffic
    with span("feasible_lasso"):
        sol = tcd.feasible_lasso(X, y, state.lam0, options=state.opts,
                                 device=X.device)
    with span("polish_feasible_lasso"):
        res = tcd.polish_feasible_lasso(
            X, y, sol.x, state.lam0, target_rel_gap=tr["target_rel_gap"],
            gamma_rtol=tr["gamma_rtol"], device=X.device)
    return Outcome(bool(res.converged),
                   {"solve": sol.x, "solve_loadings": sol.penalty.weights,
                    "polish": res.beta, "loadings": res.loadings}, {})
