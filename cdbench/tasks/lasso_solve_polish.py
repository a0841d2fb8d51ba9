"""One problem = a cold ``lasso`` at ``lam_frac``·λmax(y) for a fresh
response, with the traffic's options, then ``polish_lasso`` of its
solution to the relative duality gap ``target_rel_gap``.  Certified when
the polish reached it.  Both stages' coefficients are judged: the float32
solve's (the polish would repair a solve that ran in a lower precision)
and the polished float64 ones."""

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
    opts: object
    traffic: dict
    seed: int
    pool: int


def prepare(cfg, traffic, seed, dev) -> State:
    X = data.gauss_design(cfg, seed, dev)
    pool = int(traffic["pool"])
    Y = data.scattered_responses(X, pool + 1, traffic["planted"],
                                 traffic["noise"], seed)
    lams = (traffic["lam_frac"]
            * data.lambda_max(X, Y).double().cpu().numpy()).astype(np.float32)
    return State(X, Y, lams, tcd.CDOptions(**traffic["options"]), traffic,
                 seed, pool)


def solve(state: State, k: int, span) -> Outcome:
    X, y, lam = state.X, state.Y[k], float(state.lams[k])
    with span("lasso"):
        sol = tcd.lasso(X, y, lam, options=state.opts, device=X.device)
    with span("polish_lasso"):
        res = tcd.polish_lasso(
            X, y, sol.x, lam, target_rel_gap=state.traffic["target_rel_gap"],
            device=X.device)
    return Outcome(bool(res.converged), {"solve": sol.x, "polish": res.beta},
                   {})
