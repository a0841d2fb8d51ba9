"""Numeric helpers (counterpart of ``coordinatedescent_jl_tpu/utils/helpers.py``)
and the entry points' device rule."""

from __future__ import annotations

import torch

from . import host
from ..kernels.gradient_sweep import loadings_sweep


def target_device(device=None) -> torch.device:
    """The device an entry point runs on.  ``None`` means ``"cuda"``: the
    port runs on the GPU unless the caller asks for the CPU.  Raises a
    ``RuntimeError`` when CUDA is asked for and no CUDA device is usable;
    it never runs on the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no usable CUDA device: the port runs on the GPU by default; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev


def on_device(x, device: torch.device, dtype=None) -> torch.Tensor:
    """``x`` (numpy array, tensor, list or scalar) as a tensor on
    ``device``, optionally cast to ``dtype``."""
    return torch.as_tensor(x).to(device=device, dtype=dtype)


def std_X(X, w=None):
    """Per-column root-mean-square loadings: ``sqrt(mean(X_j^2))``, or
    ``sqrt(Σ_i w_i X_ij^2 / n)`` when weighted (divisor ``n``, not ``Σw``)."""
    n = X.shape[0]
    if w is None:
        v = torch.sum(X * X, dim=0)
    else:
        v = torch.einsum("i,ij->j", w, X * X)
    return torch.sqrt(v / n)


def sample_std(r):
    """Corrected sample standard deviation (mean-centered, ``n-1`` divisor)
    — the σ reported by ``lasso``."""
    n = r.shape[0]
    m = torch.mean(r)
    return torch.sqrt(torch.sum((r - m) ** 2) / (n - 1))


def get_loadings(X, e):
    """Heteroscedastic penalty loadings ``sqrt(mean((X_ij e_i)^2))`` (the
    feasible Lasso's)."""
    n = X.shape[0]
    return torch.sqrt(torch.einsum("i,ij->j", e * e, X * X) / n)


def get_loadings_blocked(Xb, e, p: int):
    """``get_loadings`` from the blocked design ``Xb (nb, n, B)`` through
    the loadings sweep (``kernels/gradient_sweep.py::loadings_sweep``: one
    launch and one read of the design on the card; the plain twin squares
    16 column blocks at a time on the CPU), so that no design-sized
    ``X∘X`` temporary is made (4 GB at n = 10K, p = 100K).
    Padded columns are all-zero (loading 0) and are sliced off.  Marked
    ``cdt#loadings`` with the shape and the accumulation's item size."""
    n = Xb.shape[1]
    ee = e * e
    with host.mark("loadings", n=n, p=p, x_item=Xb.element_size(),
                   acc=ee.element_size()):
        s = loadings_sweep(Xb, ee)    # (nb, B)
        return torch.sqrt(s.reshape(-1)[:p] / n)


def min_norm_lstsq(A, b):
    """The minimum-norm least-squares solutions of ``A x ≈ b`` for a batch
    (``A (..., m, k)``, ``b (..., m)``; returns ``(..., k)``) through the
    thin SVD, with ``numpy.linalg.lstsq(rcond=None)``'s rank cut per
    matrix: singular values ≤ ``eps·max(m, k)`` times that matrix's
    largest count as zero.  The same routine on every device (on the card
    ``torch.linalg.lstsq`` has only QR, which assumes full column rank)."""
    U, s, Vh = torch.linalg.svd(A, full_matrices=False)
    cut = torch.finfo(A.dtype).eps * max(A.shape[-2:]) * s[..., :1]
    inv = torch.where(s > cut, 1.0 / s, torch.zeros_like(s))
    Utb = (U.mT @ b[..., None])[..., 0]
    return (Vh.mT @ (inv * Utb)[..., None])[..., 0]


def get_sigma(w, r):
    """Weighted residual scale ``sqrt(Σ w_i r_i^2 / Σ w_i)``."""
    return torch.sqrt(torch.sum(r * r * w) / torch.sum(w))


def find_largest_correlations(X, y, s: int, w=None):
    """Indices of the ``s`` columns with the largest ``|X_j' y|`` (or the
    weighted ``|Σ_i X_ij w_i y_i|``), ties toward the lower index as
    ``lax.top_k`` breaks them."""
    c = torch.abs((y if w is None else w * y) @ X)
    return torch.sort(c, descending=True, stable=True)[1][:s]


def find_init_residuals(X, y, s: int, w=None):
    """Residuals of the (weighted) OLS of ``y`` on its ``s`` most
    correlated columns, through the normal equations with an eps-scaled
    jitter, as the JAX package writes them (both packages then pick the
    same start, also when the top-s columns are collinear)."""
    return ols_residuals(X.index_select(1, find_largest_correlations(
        X, y, s, w)), y, w)


def ols_residuals(Xs, y, w=None):
    """Residuals of the (weighted) OLS of ``y`` on the columns ``Xs``,
    through the normal equations with the eps-scaled jitter of
    :func:`find_init_residuals`."""
    s = Xs.shape[1]
    A = Xs.T @ Xs if w is None else Xs.T @ (w[:, None] * Xs)
    b = y @ Xs if w is None else (w * y) @ Xs
    jitter = (10 * torch.finfo(Xs.dtype).eps * torch.trace(A) / s) * torch.eye(
        s, dtype=A.dtype, device=A.device)
    coef = torch.linalg.solve(A + jitter, b)
    return y - Xs @ coef


def find_init_sigma(X, y, s: int):
    """Initial σ upper bound: the sample std of the screened-OLS
    residuals."""
    return sample_std(find_init_residuals(X, y, s))
