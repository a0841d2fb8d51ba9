"""Smooth-loss specifications (counterpart of
``coordinatedescent_jl_tpu/ops/losses.py``).  A loss is an immutable record
of tensors plus a static ``kind`` tag; the solver state lives in
``ops/block_cd.py``.

- ``LeastSquaresLoss(y, X)``  — ``‖y − Xβ‖² / (2n)``
- ``WeightedLSLoss(y, X, w)`` — ``Σ_i w_i (y_i − X_i β)² / (2n)``
- ``SqrtLassoLoss(y, X)``     — ``‖y − Xβ‖₂`` (not ``/√n``: the gradient
  and the exact coordinate minimizer are those of plain ``‖r‖``)
- ``QuadraticLoss(A, b)``     — ``x'Ax/2 + x'b`` (A symmetric)
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LeastSquaresLoss(NamedTuple):
    y: torch.Tensor
    X: torch.Tensor

    kind = "ls"


class WeightedLSLoss(NamedTuple):
    y: torch.Tensor
    X: torch.Tensor
    w: torch.Tensor

    kind = "wls"


class SqrtLassoLoss(NamedTuple):
    y: torch.Tensor
    X: torch.Tensor

    kind = "sqrt"


class QuadraticLoss(NamedTuple):
    A: torch.Tensor
    b: torch.Tensor

    kind = "quad"


def num_coordinates(loss) -> int:
    """Number of coordinates the solver iterates over."""
    if isinstance(loss, QuadraticLoss):
        return loss.b.shape[0]
    return loss.X.shape[1]


def gradient(loss, beta):
    """Full gradient of the smooth part at ``beta``: ``−X'r/n`` (ls),
    ``−X'(w∘r)/n`` (wls), ``−X'r/‖r‖`` (sqrt), ``Aβ + b`` (quad)."""
    if isinstance(loss, QuadraticLoss):
        return loss.A @ beta + loss.b
    r = loss.y - loss.X @ beta
    n = loss.y.shape[0]
    if isinstance(loss, LeastSquaresLoss):
        return -(r @ loss.X) / n
    if isinstance(loss, WeightedLSLoss):
        return -((loss.w * r) @ loss.X) / n
    if isinstance(loss, SqrtLassoLoss):
        return -(r @ loss.X) / torch.linalg.vector_norm(r)
    raise TypeError(f"unsupported loss: {type(loss)!r}")


def value(loss, beta):
    """Objective value of the smooth part at ``beta``."""
    if isinstance(loss, QuadraticLoss):
        return 0.5 * torch.dot(beta, loss.A @ beta) + torch.dot(beta, loss.b)
    r = loss.y - loss.X @ beta
    n = loss.y.shape[0]
    if isinstance(loss, LeastSquaresLoss):
        return torch.sum(r * r) / (2 * n)
    if isinstance(loss, WeightedLSLoss):
        return torch.sum(loss.w * r * r) / (2 * n)
    if isinstance(loss, SqrtLassoLoss):
        return torch.sqrt(torch.dot(r, r))
    raise TypeError(f"unsupported loss: {type(loss)!r}")
