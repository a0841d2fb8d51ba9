"""One problem = one ``locpolyl1`` fit over the configuration's grid for a
fresh data set (design, z and response drawn anew), with the port's
defaults (the batched grid on the card, ``grid_batch`` 128); the L1
coefficients ``(p(degree+1), points)`` are judged: those of the sampled
fits, and of every fit that fell back to the scan."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

import coordinatedescent_jl_tpu_torch as tcd

from .. import data
from . import Outcome


class State(NamedTuple):
    X: torch.Tensor         # (pool + 1, n, p)
    z: torch.Tensor         # (pool + 1, n)
    Y: torch.Tensor         # (pool + 1, n)
    grid: np.ndarray        # float32, the values both sides use
    degree: int
    h: float                # float32 values, as host floats
    lam0: float
    traffic: dict
    seed: int
    pool: int


def prepare(cfg, traffic, seed, dev) -> State:
    if cfg["kernel"] != "gaussian":
        raise ValueError(f"vc_grid: kernel {cfg['kernel']!r}")
    pool = int(traffic["pool"])
    X, z, Y = data.vc_problems(cfg, pool + 1, traffic["noise"], seed, dev)
    g = cfg["grid"]
    grid = np.linspace(g["lo"], g["hi"], g["points"]).astype(np.float32)
    return State(X, z, Y, grid, int(cfg["degree"]),
                 float(np.float32(cfg["h"])), float(np.float32(cfg["lam0"])),
                 traffic, seed, pool)


def solve(state: State, k: int, span) -> Outcome:
    st = {}
    with span("locpolyl1"):
        out, _ = tcd.locpolyl1(state.X[k], state.z[k], state.Y[k], state.grid,
                               state.degree, tcd.GaussianKernel(state.h),
                               state.lam0, stats=st, device=state.Y.device)
    # a grid the batched refinement does not certify is solved again by
    # the sequential scan (the entry point's documented fallback), which
    # hands back no certificate: the reference judges every such fit
    fell_back = bool(st["used_batched"]) and not st["batched_certified"]
    return Outcome(True, out, {"scan_fallbacks": int(fell_back)},
                   uncertified_path=fell_back)
