"""Lasso estimator (counterpart of ``coordinatedescent_jl_tpu/models/lasso.py``;
the sqrt, scaled and feasible estimators are not ported yet)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.block_cd import coordinate_descent
from ..ops.losses import LeastSquaresLoss
from ..ops.prox import ProxL1
from ..utils.helpers import on_device, sample_std, target_device
from ..utils.options import CDOptions


class LassoSolution(NamedTuple):
    """Result record: dense coefficients (zeros encode sparsity), the
    residuals ``y − Xβ``, the penalty and the residual scale estimate."""

    x: torch.Tensor
    residuals: torch.Tensor
    penalty: ProxL1
    sigma: Optional[torch.Tensor]


def lasso(X, y, lam, weights=None, options: CDOptions = CDOptions(), *,
          seed: int = 0, device=None) -> LassoSolution:
    """(Weighted) Lasso ``min ‖y−Xβ‖²/(2n) + λ Σ ω_j |β_j|``; σ is the
    sample std of the residuals.  Runs on ``device`` (``None``: the GPU,
    raising when there is none; ``"cpu"`` for the plain path on the CPU),
    where the inputs are moved."""
    dev = target_device(device)
    X = on_device(X, dev)
    y = on_device(y, dev, X.dtype)
    g = ProxL1(float(lam), None if weights is None else
               on_device(weights, dev, X.dtype))
    beta0 = torch.zeros((X.shape[1],), dtype=X.dtype, device=dev)
    beta, r = coordinate_descent(beta0, LeastSquaresLoss(y, X), g, options,
                                 seed=seed, device=dev)
    return LassoSolution(beta, r, g, sample_std(r))
