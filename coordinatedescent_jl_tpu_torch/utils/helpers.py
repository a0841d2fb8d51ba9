"""Numeric helpers (counterpart of ``coordinatedescent_jl_tpu/utils/helpers.py``)
and the entry points' device rule."""

from __future__ import annotations

import torch


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
