"""Plain varying-coefficient L1 fit: the reference of ``locpolyl1``.

At each grid point ``z0``, from the objective alone: kernel weights
``w_i = exp(−(z_i − z0)²/h)/h`` (the upstream package's Gaussian kernel:
no √π, h not squared), the local design ``eX[i, (j, d)] = X_ij (z_i −
z0)^d`` (feature-major, degree-minor), the penalty loadings ``ω_j =
sqrt(Σ_i w_i eX_ij² / n)``, and

    argmin_b  ½ Σ_i w_i (y_i − eX_i b)²  +  n·λ0·Σ_j ω_j |b_j|

solved exactly for every point at once (``solvers.gram_lasso``).  Plain
PyTorch; imports nothing of the port.
"""

from __future__ import annotations

import torch

from .solvers import gram_lasso

# grid points a batch: bounds eX to _BATCH x n x p(degree+1) numbers
_BATCH = 256


def locpolyl1(X, z, y, zgrid, degree: int, h: float, lam0: float, *,
              dtype=torch.float64):
    """The fit at every point of ``zgrid``, ``(p(degree+1), len(zgrid))``
    in ``dtype``."""
    n, p = X.shape
    Xd, zd, yd = X.to(dtype), z.to(dtype), y.to(dtype)
    g = torch.as_tensor(zgrid, device=X.device).to(dtype)
    pw = torch.arange(degree + 1, device=X.device, dtype=dtype)
    outs = []
    for a in range(0, g.shape[0], _BATCH):
        z0 = g[a:a + _BATCH]
        m = z0.shape[0]
        dz = zd[None, :] - z0[:, None]                       # (m, n)
        w = torch.exp(-(dz * dz) / h) / h
        eX = (Xd[None, :, :, None] * (dz[:, :, None, None] ** pw)).reshape(
            m, n, p * (degree + 1))
        wX = w[:, :, None] * eX
        K = wX.mT @ eX
        c = (wX.mT @ yd[:, None])[:, :, 0]
        lamw = torch.sqrt(torch.diagonal(K, dim1=1, dim2=2) / n)
        outs.append(gram_lasso(K, c, n * lam0 * lamw))
    return torch.cat(outs).T
