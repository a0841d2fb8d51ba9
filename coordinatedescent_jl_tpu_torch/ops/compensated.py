"""Float64-accumulated certification (counterpart of
``coordinatedescent_jl_tpu/ops/compensated.py``, the pieces the polishes
and the compensated certificates need).

- ``grad_f64`` — ``X'r`` with float64 accumulation over the float32
  design: K5's f64-accumulating instantiation on the card
  (``kernels/gradient_sweep.py``), its plain twin on the CPU.
- ``residual_f64`` — the exact float64 residual of a sparse β through a
  gathered support block.
- ``fenchel_gap_f64`` — the host float64 Fenchel gap finish.
- ``lasso_duality_gap_compensated`` — the measurement-grade gap built
  from the three.
- ``sqrt_lasso_kkt_compensated`` — the sqrt-lasso's measurement-grade
  relative KKT residual (``_sqrt_kkt_rel_from_grad`` its roll-up).
- ``group_lasso_kkt_compensated`` — the group Lasso's measurement-grade
  per-group relative KKT residual (``_group_kkt_pieces`` its roll-up).
- ``loadings_f64`` — the feasible Lasso's loadings with float64
  accumulation: the loadings sweep's float64 form on the card
  (``kernels/gradient_sweep.py::loadings_f64_sweep``, K5's kernel with the
  element squared; an einsum outside any kernel in the JAX package), its
  column-chunked plain twin on the CPU.

What is not ported, and why: the JAX package's hybrid sweep
``grad_f64_certified`` (with ``_grad32_and_mag``, ``_hybrid_estimate`` and
``_exact_cols``) exists because float64 is emulated on a TPU, where the
full f64 sweep costs ~6× an f32 one; it computes exact values only where
the certificate can read them.  The H100 has native float64, and the full
f64-accumulating sweep is one read of the float32 design, so the port
uses ``grad_f64`` wherever the JAX package calls the hybrid: the sqrt and
group certificates then read the exact f64 gradient at every coordinate,
which is stricter than the hybrid's "exact where it matters" (the group
roll-up's ``n_exact`` is every group, and its ``cap`` on the exact
recompute goes with the hybrid).  The gradient
sweeps' ``col_chunk`` arguments bounded the TPU emulation's temporaries
and are dropped with it: the certificates and the polishes still take the
keyword, check it (:func:`check_col_chunk`) and ignore it.
``loadings_f64`` keeps its own for its plain twin (a whole-design float64
``X∘X`` would be 8 GB at n = 10K, p = 100K).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.gradient_sweep import grad_f64, loadings_f64_sweep
from ..utils import host
from ..utils.helpers import on_device, target_device

__all__ = ["grad_f64", "residual_f64", "fenchel_gap_f64",
           "lasso_duality_gap_compensated", "sqrt_lasso_kkt_compensated",
           "group_lasso_kkt_compensated", "loadings_f64"]


def host_f64(x) -> np.ndarray:
    """``x`` (tensor on any device, or array-like) as a host float64 numpy
    array; a tensor's read is counted."""
    if isinstance(x, torch.Tensor):
        return host.numpy(x.to(torch.float64))
    return np.asarray(x, np.float64)


def check_col_chunk(col_chunk, name: str = "col_chunk") -> None:
    """Check the JAX package's ``col_chunk=`` keyword (or another bound of
    its chunked sweeps, ``name``), which the port takes and ignores (its
    f64 sweep reads the design once, unchunked): a positive int, else
    ``ValueError``."""
    if (isinstance(col_chunk, bool)
            or not isinstance(col_chunk, (int, np.integer)) or col_chunk < 1):
        raise ValueError(f"{name} must be a positive int, got {col_chunk!r}")


def residual_f64(X, y, idx, beta_s64):
    """Exact float64 residual ``y − X[:, idx] @ beta_s`` of a sparse β whose
    support lies in ``idx`` (slots with ``idx == p`` are padding: zero
    columns).  The ``(n, C)`` gather is the only design traffic."""
    p = X.shape[1]
    Xs = X.index_select(1, torch.clamp_max(idx, p - 1)).to(torch.float64)
    beta_s64 = torch.where(idx < p, beta_s64, torch.zeros_like(beta_s64))
    return y.to(torch.float64) - Xs @ beta_s64


def _support_residual(X, y, beta_np):
    """Exact float64 residual of ``beta_np`` (host float64) through its
    gathered support, padded to a multiple of 128 columns.  Returns
    ``(r64, sup)``."""
    p = X.shape[1]
    sup = np.nonzero(beta_np)[0]
    C = min(p, max(128, -(-max(1, sup.size) // 128) * 128))
    idx = np.full((C,), p, np.int64)
    idx[:sup.size] = sup
    beta_s = np.zeros((C,), np.float64)
    beta_s[:sup.size] = beta_np[sup]
    r64 = residual_f64(X, y, torch.as_tensor(idx, device=X.device),
                       torch.as_tensor(beta_s, device=X.device))
    return r64, sup


def fenchel_gap_f64(r_np, g_np, beta_np, lam0, w, n, yn, y2=None):
    """Host-f64 Fenchel gap finish shared by
    ``lasso_duality_gap_compensated`` and ``models.polish.polish_lasso``:
    ``θ = r · min(1, 1/max_j |g_j|/(nλw_j))`` is dual-feasible, the dual
    uses the cancellation-safe ``(‖y‖² − ‖y−θ‖²)/(2n)``.  Returns
    ``(gap, primal)``."""
    lam0 = float(lam0)
    ratio = np.max(np.abs(g_np) / (n * lam0 * w))
    theta = r_np * min(1.0, 1.0 / max(ratio, 1e-300))
    primal = float(r_np @ r_np / (2 * n)
                   + lam0 * np.sum(w * np.abs(beta_np)))
    if y2 is None:
        y2 = float(yn @ yn)
    dual = float((y2 - (yn - theta) @ (yn - theta)) / (2 * n))
    return primal - dual, primal


def lasso_duality_gap_compensated(X, y, beta, lam0, weights=None, *,
                                  col_chunk: int = 4096, device=None):
    """Measurement-grade ``(gap, primal)``, every accumulation float64: the
    exact residual through the gathered support, the full f64-accumulating
    gradient sweep, the scalar finish in host float64.  ``col_chunk`` is
    checked and ignored (the sweep is not chunked).  Runs on ``device``
    (``None``: the GPU, raising when there is none; ``"cpu"``: the plain
    twins on the CPU)."""
    check_col_chunk(col_chunk)
    dev = target_device(device)
    X = on_device(X, dev).contiguous()
    y = on_device(y, dev)
    n, p = X.shape
    beta_np = host_f64(beta)
    w = np.ones((p,), np.float64) if weights is None else host_f64(weights)
    r64, _ = _support_residual(X, y, beta_np)
    return fenchel_gap_f64(host_f64(r64), host_f64(grad_f64(X, r64)),
                           beta_np, lam0, w, n, host_f64(y))


def _sqrt_kkt_rel_from_grad(g_np, t, sup, beta_np):
    """Sqrt-lasso KKT roll-up from the float64 gradient, shared by
    ``sqrt_lasso_kkt_compensated`` and ``models.polish.polish_sqrt_lasso``:
    the off-support excess ``max(|g_j| − t_j, 0)/t_j`` and the on-support
    stationarity deviation ``|g_j − t_j·sign β_j|/t_j``, the larger of the
    two maxima."""
    off_rel = float(np.max(np.maximum(np.abs(g_np) - t, 0.0) / t))
    on_rel = (float(np.max(
        np.abs(g_np[sup] - t[sup] * np.sign(beta_np[sup])) / t[sup]))
        if sup.size else 0.0)
    return max(off_rel, on_rel)


def sqrt_lasso_kkt_compensated(X, y, beta, lam0, weights=None, *,
                               col_chunk: int = 4096, device=None):
    """Measurement-grade sqrt-lasso KKT residual, relative to the
    threshold scale ``t_j = λ‖r‖w_j`` of the zero rule: 0 at an exact
    solution, each violation measured against its own coordinate's
    threshold.  The exact float64 residual through the gathered support,
    the full f64-accumulating gradient sweep, every scalar float64.
    Returns ``(kkt_rel, norm_r)``.  ``col_chunk`` is checked and ignored
    (the sweep is not chunked).  Runs on ``device`` (``None``: the GPU,
    raising when there is none; ``"cpu"``: the plain twins on the CPU)."""
    check_col_chunk(col_chunk)
    dev = target_device(device)
    X = on_device(X, dev).contiguous()
    y = on_device(y, dev)
    p = X.shape[1]
    beta_np = host_f64(beta)
    w = np.ones((p,), np.float64) if weights is None else host_f64(weights)
    r64, sup = _support_residual(X, y, beta_np)
    r_np = host_f64(r64)
    rn = float(np.sqrt(r_np @ r_np))
    t = np.maximum(float(lam0) * rn * w, 1e-300)
    g_np = host_f64(grad_f64(X, r64))
    return _sqrt_kkt_rel_from_grad(g_np, t, sup, beta_np), rn


def _group_kkt_pieces(X, y, beta_np, t, G: int):
    """Group-KKT roll-up shared by ``group_lasso_kkt_compensated`` and
    ``models.polish.polish_group_lasso``: the exact float64 residual through
    the support, the full f64-accumulating sweep ``g = X'r``, then in host
    float64 the per-group off-support excess ``max(‖g_g‖ − t_g, 0)/t_g`` and,
    on the active groups, the stationarity deviation ``‖g_g −
    t_g·β_g/‖β_g‖‖/t_g``.  Returns ``(kkt_rel, off_excess (ng,),
    n_exact)``, ``n_exact`` being every group (the sweep is exact
    everywhere)."""
    p = X.shape[1]
    ng = -(-p // G)
    r64, _ = _support_residual(X, y, beta_np)
    g_np = host_f64(grad_f64(X, r64))
    pad = ng * G - p
    gg = np.pad(g_np, (0, pad)).reshape(ng, G)
    bg = np.pad(beta_np, (0, pad)).reshape(ng, G)
    off_excess = np.maximum(np.linalg.norm(gg, axis=1) - t, 0.0) / t
    bn = np.linalg.norm(bg, axis=1)
    act = np.nonzero(bn > 0)[0]
    on_rel = (float(np.max(np.linalg.norm(
        gg[act] - t[act, None] * bg[act] / bn[act, None], axis=1) / t[act]))
        if act.size else 0.0)
    return max(float(np.max(off_excess)), on_rel), off_excess, ng


def group_lasso_kkt_compensated(X, y, beta, lam0, group_size: int,
                                weights=None, *, col_chunk: int = 4096,
                                cap: int = 8192, device=None):
    """Measurement-grade group-lasso KKT residual relative to the threshold
    scale ``t_g = n·λ0·ω_g``: zero groups need ``‖X_g'r‖₂ ≤ t_g``, active
    groups ``X_g'r = t_g·β_g/‖β_g‖``.  Every accumulation float64 (see
    :func:`_group_kkt_pieces`).  Returns ``(kkt_rel, n_exact_groups)``.
    ``col_chunk`` and ``cap`` (the JAX package's bounds on its hybrid
    sweep) are checked and ignored.  Runs on ``device`` (``None``: the GPU,
    raising when there is none; ``"cpu"``: the plain twins on the CPU)."""
    check_col_chunk(col_chunk)
    check_col_chunk(cap, "cap")
    dev = target_device(device)
    X = on_device(X, dev).contiguous()
    y = on_device(y, dev)
    n, p = X.shape
    G = int(group_size)
    ng = -(-p // G)
    w = np.ones((ng,), np.float64) if weights is None else host_f64(weights)
    t = np.maximum(n * float(lam0) * w, 1e-300)
    kkt_rel, _, n_exact = _group_kkt_pieces(X, y, host_f64(beta), t, G)
    return kkt_rel, n_exact


def loadings_f64(X, r64, col_chunk: int = 2048):
    """Heteroscedastic penalty loadings ``sqrt(mean((X_ij r_i)²))`` with
    float64 squares and accumulation (the float32 form's squared terms
    alone carry ~6e-8 relative error, too coarse to certify the feasible
    Lasso's loading fixed point at 1e-7): one launch and one read of X on
    the card (``loadings_f64_sweep``); on the CPU ``col_chunk`` columns at
    a time, each one ``(n, chunk)`` float64 square and one float64 product,
    no design-sized temporary.  Marked ``cdt#loadings`` as
    ``get_loadings_blocked`` is."""
    n, p = X.shape
    rr = r64 * r64
    with host.mark("loadings", n=n, p=p, x_item=X.element_size(),
                   acc=rr.element_size()):
        return torch.sqrt(loadings_f64_sweep(X, rr, col_chunk=col_chunk)
                          / n)
