"""Duality gap and KKT residual for the (weighted) Lasso (counterpart of
``coordinatedescent_jl_tpu/ops/diagnostics.py``).

``P(β) = ‖y − Xβ‖²/(2n) + λ0 Σ_j ω_j |β_j|``, with the dual certificate
``θ = r·min(1, 1/max_j |X_j'r|/(n λ0 ω_j))``.  These are the parity
yardstick between the two packages and the port's convergence check on
the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.gradient_sweep import _F64_COLS
from .compensated import fenchel_gap_f64, grad_f64, host_f64
from ..utils.helpers import on_device, target_device


def lasso_duality_gap(X, y, beta, lam0, weights=None):
    """Fenchel duality gap for the (weighted) Lasso, in the working dtype.
    Returns a 0-d tensor ≥ 0 (up to rounding)."""
    n = y.shape[0]
    r = y - X @ beta
    g = r @ X
    if weights is None:
        weights = torch.ones_like(beta)
    ratio = torch.max(torch.abs(g) / (n * lam0 * weights))
    scale = torch.clamp(1.0 / torch.clamp_min(ratio, 1e-30), max=1.0)
    theta = r * scale
    primal = torch.sum(r * r) / (2 * n) + lam0 * torch.sum(
        weights * torch.abs(beta))
    dual = (torch.sum(y * y) - torch.sum((y - theta) ** 2)) / (2 * n)
    return primal - dual


def lasso_duality_gap_f64(X, y, beta, lam0, weights=None, *, device=None):
    """Float64 duality gap ``(gap, primal)`` as Python floats.

    The two O(n·p) contractions ``r = y − Xβ`` and ``g = X'r`` run on
    ``device`` (``None``: the GPU, raising when there is none; ``"cpu"``
    for the CPU) with float64 accumulation — ``r`` with X widened a column
    chunk at a time, ``g`` through ``ops/compensated.py::grad_f64`` (the
    dense sweep kernel K5 on the card) — so the certificate is not limited
    by the float32 rounding of the solver's own dot products; the O(n + p)
    tail runs in float64 on the host."""
    dev = target_device(device)
    X = on_device(X, dev)
    y = on_device(y, dev)
    n, p = X.shape
    b64 = on_device(beta, dev, torch.float64)
    r = y.to(torch.float64).clone()
    for j in range(0, p, _F64_COLS):
        r -= X[:, j:j + _F64_COLS].to(torch.float64) @ b64[j:j + _F64_COLS]
    g = grad_f64(X.contiguous(), r)
    bn = host_f64(b64)
    w = np.ones_like(bn) if weights is None else host_f64(weights)
    return fenchel_gap_f64(host_f64(r), host_f64(g), bn, lam0, w, n,
                           host_f64(y))


def lasso_kkt_residual(X, y, beta, lam0, weights=None):
    """Max KKT violation ``max_j (|X_j'(y−Xβ)|/n − λ0 ω_j)_+`` plus the
    on-support stationarity error."""
    n = y.shape[0]
    r = y - X @ beta
    g = (r @ X) / n
    if weights is None:
        weights = torch.ones_like(beta)
    lam = lam0 * weights
    off = torch.clamp_min(torch.abs(g) - lam, 0.0)
    on = torch.where(beta != 0, torch.abs(g - lam * torch.sign(beta)),
                     torch.zeros_like(g))
    return torch.maximum(torch.max(off), torch.max(on))
