"""One problem = one λ path of ``lasso_path`` on the resident design, for
a fresh response: ``points`` λ values log-spaced from ``lam_hi``·λmax(y)
to ``lam_lo``·λmax(y), the batched execution (``path_batch``,
``coarse_stride``), the traffic's solver options, no standardization.
Certified when the batched refinement certified every point."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

import coordinatedescent_jl_tpu_torch as tcd

from .. import data
from . import Outcome


class State(NamedTuple):
    X: torch.Tensor         # (n, p) design
    Y: torch.Tensor         # (pool + 1, n) responses
    lams: np.ndarray        # (pool + 1, points) float32, decreasing
    opts: object
    traffic: dict
    seed: int
    pool: int


def prepare(cfg, traffic, seed, dev) -> State:
    X = data.gauss_design(cfg, seed, dev)
    pool = int(traffic["pool"])
    Y = data.scattered_responses(X, pool + 1, traffic["planted"],
                                 traffic["noise"], seed)
    lmax = data.lambda_max(X, Y).double().cpu().numpy()
    frac = np.exp(np.linspace(np.log(traffic["lam_hi"]),
                              np.log(traffic["lam_lo"]), traffic["points"]))
    lams = (lmax[:, None] * frac[None, :]).astype(np.float32)
    return State(X, Y, lams, tcd.CDOptions(**traffic["options"]), traffic,
                 seed, pool)


def solve(state: State, k: int, span) -> Outcome:
    st = {}
    with span("lasso_path"):
        path = tcd.lasso_path(state.X, state.Y[k], state.lams[k],
                              options=state.opts, standardize_X=False,
                              path_batch=state.traffic["path_batch"],
                              coarse_stride=state.traffic["coarse_stride"],
                              stats=st, device=state.X.device)
    ok = (bool(st["batched_certified"])
          and path.beta_path.shape[0] == state.lams.shape[1])
    return Outcome(ok, path.beta_path, {"refine_rounds": st["refine_rounds"]})
