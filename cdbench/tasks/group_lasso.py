"""One problem = ``group_lasso`` over contiguous groups of ``G`` columns at
``lam_frac``·max_g ‖X_g'y‖/n for a fresh response (``n_act`` planted
groups at 1.0, plus noise), with the traffic's options, then
``polish_group_lasso`` of its solution.  Certified when the polish reached
its per-group relative KKT target.  Both stages' coefficients are judged:
the float32 group solve's (the polish would repair a solve that ran in a
lower precision) and the polished ones."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

import coordinatedescent_jl_tpu_torch as tcd

from .. import data
from . import Outcome


class State(NamedTuple):
    X: torch.Tensor
    Y: torch.Tensor         # (pool + 1, n)
    lams: np.ndarray        # (pool + 1,) float32
    G: int
    opts: object
    traffic: dict
    seed: int
    pool: int


def prepare(cfg, traffic, seed, dev) -> State:
    X = data.gauss_design(cfg, seed, dev)
    pool, G = int(traffic["pool"]), int(traffic["G"])
    Y = data.group_responses(X, pool + 1, G, traffic["n_act"],
                             traffic["noise"], seed)
    lams = (traffic["lam_frac"] * data.group_lambda_max(
        X, Y, G).double().cpu().numpy()).astype(np.float32)
    return State(X, Y, lams, G, tcd.CDOptions(**traffic["options"]),
                 traffic, seed, pool)


def solve(state: State, k: int, span) -> Outcome:
    X, y, lam, G = state.X, state.Y[k], float(state.lams[k]), state.G
    with span("group_lasso"):
        sol = tcd.group_lasso(X, y, lam, G, options=state.opts,
                              device=X.device)
    with span("polish_group_lasso"):
        res = tcd.polish_group_lasso(X, y, sol.x, lam, G, device=X.device)
    return Outcome(bool(res.converged), {"solve": sol.x, "polish": res.beta},
                   {})
