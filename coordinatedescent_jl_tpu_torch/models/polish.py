"""Active-set float64 polish: from an f32 Lasso solve to the 1e-7 duality
gap (counterpart of ``coordinatedescent_jl_tpu/models/polish.py::polish_lasso``;
the sqrt, scaled, feasible and group polishes are not ported yet).

The host loop is the JAX package's: the f32 solution's support plus 25 %
slack, rounded up to a multiple of 128, becomes the working set; the
restricted problem is solved by cyclic exact coordinate descent in
float64 on the gathered columns; one float64-accumulated full sweep
``X'r`` certifies all p coordinates, and coordinates that violate join
the working set (at most ``max(256, C)`` per round) until the relative
gap is ≤ ``target_rel_gap``.  If a round adds no coordinate, the inner
tolerance tightens ×10.

What differs on the H100:

- The certificate's sweep is the full f64-accumulating ``grad_f64`` (K5
  on the card), not the JAX package's hybrid ``grad_f64_certified``,
  which exists because f64 is emulated on a TPU (``ops/compensated.py``).
- The inner solve (:func:`_restricted_cd_f64`).  The JAX package's
  residual form, its matvec-only contractions and its 1e-30 guards answer
  the TPU's emulated f64; on a card with native f64 a Python loop of
  per-coordinate ops would cost ~6 launches per coordinate visit.  The
  port runs its own block pass instead (``block_cd._active_pass`` with
  ``inner="exact"``, ``randomize=False``, every block active: K1 on the
  card) over the gathered float64 columns in blocks of 128 with cached
  Grams.  Exact Gauss-Seidel through the Gram recursion visits the same
  coordinates in the same order with the same closed-form update, so the
  iterates are the JAX package's up to rounding; the exact residual
  ``y − X_S β`` is recomputed at the end.

The returned β is float64: the certificate belongs to the f64 iterate.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops.block_cd import (BlockedProblem, CDState, _active_pass,
                            _blockify_cols, _block_grams)
from ..ops.compensated import (fenchel_gap_f64, grad_f64, host_f64,
                               residual_f64)
from ..utils import host
from ..utils.helpers import on_device, target_device
from ..utils.options import CDOptions

_INNER_B = 128   # block width of the inner solve (K1 takes B <= 128)


class PolishResult(NamedTuple):
    beta: torch.Tensor      # (p,) float64 polished coefficients
    gap: float              # absolute duality gap of beta
    rel_gap: float          # gap / primal
    primal: float
    rounds: int             # active-set rounds used
    support_size: int       # final working-set occupancy (nnz candidates)
    converged: bool         # rel_gap <= target


def _allocation(n_support: int, p: int, support_cap: int) -> int:
    """The first working-set width: the support plus 25 % slack, rounded
    up to a multiple of 128, within ``[128, min(p, support_cap)]``."""
    return min(p, min(support_cap,
                      max(128, -(-int(1.25 * n_support) // 128) * 128)))


def _restricted_problem(X, y64, lamw, idx, beta0):
    """The inner solve's inputs: the working set ``idx`` (slots with
    ``idx == p`` are padding: zero columns, pinned at 0) gathered to
    float64 blocks of ``_INNER_B`` with cached Grams, and the state at
    ``beta0`` with every block active.  Returns ``(prob, st, Xs)``."""
    n, p = X.shape
    C = idx.shape[0]
    Cb = -(-C // _INNER_B) * _INNER_B
    if Cb != C:
        idx = torch.cat([idx, torch.full((Cb - C,), p, dtype=idx.dtype,
                                         device=idx.device)])
        beta0 = torch.cat([beta0, beta0.new_zeros((Cb - C,))])
    valid = idx < p
    cols = torch.clamp_max(idx, p - 1)
    Xs = torch.where(valid[None, :], X.index_select(1, cols).to(torch.float64),
                     0.0)
    nb = Cb // _INNER_B
    Xb = _blockify_cols(Xs, _INNER_B)
    adiag = torch.sum(Xb * Xb, dim=1)
    prob = BlockedProblem(
        Xb=Xb, Xwb=Xb, y=y64, q=None, adiag=adiag,
        lamw=torch.where(valid, lamw[cols], 1.0).reshape(nb, _INNER_B),
        valid=valid.reshape(nb, _INNER_B), xwnorm=torch.sqrt(adiag),
        Kb=_block_grams(Xb, Xb))
    beta_b = beta0.reshape(nb, _INNER_B)
    st = CDState(beta=beta_b, r=y64 - Xs @ beta0,
                 rsqr=y64.new_zeros(()),
                 active=torch.ones((nb,), dtype=torch.bool, device=X.device),
                 key=None, it=0, conv=True, done=False,
                 c=torch.zeros_like(beta_b), drift=y64.new_zeros((nb,)))
    return prob, st, Xs


def _restricted_cd_f64(X, y64, lamw, idx, lam0: float, beta0, tol: float,
                       max_sweeps: int = 400):
    """Cyclic exact float64 coordinate descent on the working set ``idx``
    (see :func:`_restricted_problem`), swept until the largest coordinate
    step of a sweep is ≤ ``tol``.  Returns ``(beta (C,), r64 (n,), sweeps,
    maxh)`` with ``r64`` the exact residual of the final β."""
    n = X.shape[0]
    C = idx.shape[0]
    prob, st, Xs = _restricted_problem(X, y64, lamw, idx, beta0)
    every = st.active
    opts = CDOptions(inner="exact", randomize=False)
    sweeps, mx = 0, math.inf
    while mx > tol and sweeps < max_sweeps:
        st, maxh = _active_pass("ls", prob, st._replace(active=every), lam0,
                                float(n), False, opts)
        mx = host.item(maxh)
        sweeps += 1
    beta = st.beta.reshape(-1)
    # the exact residual of the FINAL β: the certificate must evaluate a
    # consistent (β, r) pair, not the incrementally updated one
    return beta[:C], y64 - Xs @ beta, sweeps, mx


def polish_lasso(X, y, beta, lam0, weights=None, *,
                 target_rel_gap: float = 1e-7, max_rounds: int = 6,
                 support_cap: int = 4096, device=None) -> PolishResult:
    """Refine an (f32) Lasso solution ``beta`` at penalty ``lam0`` (per-
    coordinate ``weights``) to ``rel gap ≤ target_rel_gap``.  Runs on
    ``device`` (``None``: the GPU, raising when there is none; ``"cpu"``:
    the plain twins on the CPU).  If the support outgrows ``support_cap``
    the loop stops with ``converged=False`` and the gap of that iterate is
    still reported."""
    dev = target_device(device)
    X = on_device(X, dev).contiguous()
    y = on_device(y, dev)
    n, p = X.shape
    lam0 = float(lam0)
    w_np = (np.ones((p,), np.float64) if weights is None
            else host_f64(weights))
    lamw = torch.as_tensor(w_np, device=dev)
    beta_np = host_f64(beta)
    y64 = y.to(torch.float64)
    yn = host_f64(y64)
    y2 = float(yn @ yn)

    def certify(r64, beta_full):
        g_np = host_f64(grad_f64(X, r64))
        gap, primal = fenchel_gap_f64(host_f64(r64), g_np, beta_full, lam0,
                                      w_np, n, yn, y2=y2)
        return g_np, gap, primal

    sup = np.nonzero(beta_np)[0]
    # the loop re-grows the allocation on demand; the certificate gates
    # correctness
    C = _allocation(sup.size, p, support_cap)
    rounds = 0
    converged = False
    gap = rel = primal = float("nan")
    # 1e-10·scale start; tightened ×10 when a round adds no coordinate
    tol_inner = 1e-10 * max(1.0, float(np.max(np.abs(beta_np)) or 1.0))
    while True:
        if sup.size > min(support_cap, p):
            # support over the cap: certify the current iterate (one
            # oversized gather) so the reported gap is honest, then stop
            r64 = residual_f64(X, y, torch.as_tensor(sup, device=dev),
                               torch.as_tensor(beta_np[sup], device=dev))
            _, gap, primal = certify(r64, beta_np)
            rel = gap / max(primal, 1e-300)
            break
        if sup.size > C:
            C = min(p, -(-sup.size // 128) * 128)
        idx_np = np.full((C,), p, np.int64)
        idx_np[:sup.size] = sup
        beta_s0 = np.zeros((C,), np.float64)
        beta_s0[:sup.size] = beta_np[sup]
        beta_s, r64, _, _ = _restricted_cd_f64(
            X, y64, lamw, torch.as_tensor(idx_np, device=dev), lam0,
            torch.as_tensor(beta_s0, device=dev), tol_inner)
        real = idx_np < p
        beta_np = np.zeros((p,), np.float64)
        beta_np[idx_np[real]] = host_f64(beta_s)[real]
        g_np, gap, primal = certify(r64, beta_np)
        viol = np.maximum(np.abs(g_np) / n - lam0 * w_np, 0.0)
        viol[idx_np[real]] = 0.0
        nz = np.nonzero(viol > 0)[0]
        extra_ranked = nz[np.argsort(-viol[nz])]
        rel = gap / max(primal, 1e-300)
        rounds += 1
        if rel <= target_rel_gap:
            converged = True
            break
        if rounds >= max_rounds:
            break
        # augment: support + the strongest off-set violations, at most
        # max(256, C) per round (growth is geometric, never one huge gather)
        sup_now = np.nonzero(beta_np)[0]
        room = max(0, min(support_cap, p) - sup_now.size)
        extra = extra_ranked[: min(room, max(256, C))]
        new_sup = np.union1d(sup_now, extra)
        if new_sup.size == sup.size and np.array_equal(new_sup, sup):
            # no new candidates and the gap still above target: the last
            # decade must come from more inner sweeps
            tol_inner = tol_inner / 10.0
        sup = new_sup

    return PolishResult(beta=torch.as_tensor(beta_np, device=dev),
                        gap=float(gap), rel_gap=float(rel),
                        primal=float(primal), rounds=rounds,
                        support_size=int(sup.size), converged=converged)
