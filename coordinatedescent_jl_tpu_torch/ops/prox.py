"""Proximal operators (counterpart of ``coordinatedescent_jl_tpu/ops/prox.py``).

- ``ProxL1(lam0)`` — plain L1 with scalar level ``lam0``.
- ``ProxL1(lam0, weights)`` — weighted L1, per-coordinate level
  ``lam0 * weights[j]``.
- ``ProxZero()`` — no penalty (λ = 0 in the block engine).
- ``ProxL1Group(lam0, group_size, weights)`` — group L1 over consecutive
  equal-size groups (the group engine, ``ops/group_cd.py``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def fista_momentum(iters: int, dtype) -> tuple:
    """The FISTA momentum coefficients ``(t_k − 1)/t_{k+1}`` of ``iters``
    steps, ``t_0 = 1``, ``t_{k+1} = ½(1 + √(1 + 4t_k²))``: the same for
    every block, lane and sweep, so computed once on the host in the torch
    ``dtype``'s arithmetic (as the JAX engines compute them on the device)
    and returned as Python floats, which that dtype represents exactly.
    The kernels read their device copy
    (``kernels/_build.py::momentum_table``)."""
    f = np.dtype(str(dtype).replace("torch.", "")).type
    coefs, t = [], f(1)
    for _ in range(iters):
        t_new = f(0.5) * (f(1) + np.sqrt(f(1) + f(4) * t * t))
        coefs.append(float((t - f(1)) / t_new))
        t = t_new
    return tuple(coefs)


def soft_threshold(x, t):
    """Elementwise soft-thresholding ``sign(x) * max(|x| - t, 0)``."""
    return torch.sign(x) * torch.clamp_min(torch.abs(x) - t, 0)


def sqrt_candidate(beta, c, a, rsqr, lam0, lamw):
    """Exact sqrt-lasso coordinate minimizer (three-branch soft threshold).
    With the coordinate's own contribution added back, ``s = c + a·β`` and
    ``rsqr_back = rsqr + 2βc + β²a``: zero if ``|s| ≤ λ √rsqr_back`` (which
    always holds when ``λ² ≥ a``), else
    ``sign(s)·(|s| − λ/√(1−λ²/a)·√(rsqr_back − s²/a)) / a``.  Dead columns
    (``a ≤ 0``) keep β.  Returns ``(val, s, rsqr_back)``; the caller updates
    ``‖r‖²`` to ``rsqr_back − 2·val·s + val²·a``.  The kernel evaluates the
    same expressions in the same order, one rounding per operation."""
    safe = a > 0
    asafe = torch.where(safe, a, torch.ones_like(a))
    s = c + a * beta
    rsb = torch.clamp_min(rsqr + 2.0 * beta * c + beta * beta * a, 0.0)
    lam = lam0 * lamw
    ok = safe & (lam * lam < a)
    den = torch.sqrt(torch.where(ok, 1.0 - lam * lam / asafe,
                                 torch.ones_like(asafe)))
    inner = torch.sqrt(torch.clamp_min(rsb - s * s / asafe, 0.0))
    mag = (torch.abs(s) - lam / den * inner) / asafe
    nonzero = ok & (torch.abs(s) > lam * torch.sqrt(rsb))
    val = torch.where(nonzero, torch.sign(s) * mag, torch.zeros_like(mag))
    val = torch.where(safe, val, beta)
    return val, s, rsb


class ProxL1(NamedTuple):
    """(Weighted) L1 penalty ``Σ_j lam0 · weights_j · |x_j|``."""

    lam0: float
    weights: Optional[torch.Tensor] = None

    def weight_vector(self, p: int, dtype, device) -> torch.Tensor:
        """Per-coordinate multiplicative weights (ones when unweighted)."""
        if self.weights is None:
            return torch.ones((p,), dtype=dtype, device=device)
        w = torch.as_tensor(self.weights, dtype=dtype, device=device)
        if tuple(w.shape) != (p,):
            raise ValueError(
                f"penalty weight vector has shape {tuple(w.shape)}, "
                f"expected ({p},)")
        return w


def group_soft_threshold(v, t, axis=-1, keepdims=True):
    """Group (block) soft-thresholding ``v · max(0, 1 − t/‖v‖₂)``, the prox
    of ``t·‖·‖₂`` over ``axis`` (``keepdims`` keeps the reduced axis of
    the norm, so that ``t`` broadcasts against it)."""
    nrm = torch.sqrt(torch.sum(v * v, dim=axis, keepdim=keepdims))
    scale = torch.clamp_min(1.0 - t / torch.clamp_min(nrm, 1e-30), 0.0)
    return v * scale


class ProxL1Group(NamedTuple):
    """Group-L1 penalty ``Σ_g lam0 · weights_g · ‖x_g‖₂`` over consecutive
    equal-size groups of ``group_size`` coordinates (the last group is
    ragged when ``group_size`` does not divide p); ``weights`` are per
    group, ``ceil(p / group_size)`` long."""

    lam0: float
    group_size: int = 1
    weights: Optional[torch.Tensor] = None


class ProxZero(NamedTuple):
    """No penalty: the solver minimizes the smooth loss only (λ = 0, the
    soft threshold becomes the identity)."""


def as_l1(g, p: int, dtype, device):
    """Normalize a penalty (``ProxL1`` / ``ProxZero``) to ``(lam0 as a
    Python float, weight_vector)``."""
    if isinstance(g, ProxZero):
        return 0.0, torch.ones((p,), dtype=dtype, device=device)
    if isinstance(g, ProxL1):
        return float(g.lam0), g.weight_vector(p, dtype, device)
    raise TypeError(f"unsupported penalty type: {type(g)!r}")
