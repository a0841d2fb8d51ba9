"""Active-set float64 polishes: from an f32 solve to the 1e-7 certificate
(counterpart of ``coordinatedescent_jl_tpu/models/polish.py``):
``polish_lasso`` (duality gap), ``polish_sqrt_lasso`` (compensated
relative KKT, the exact three-branch inner solve), ``polish_scaled_lasso``
(the (β, σ) fixed point), ``polish_feasible_lasso`` (the (β, Γ) loading
fixed point) and ``polish_group_lasso`` (compensated per-group relative
KKT, exact per-group subproblem solves on the host).

``polish_lasso``'s host loop is the JAX package's: the f32 solution's
support plus 25 % slack, rounded up to a multiple of 128, becomes the working set; the
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
- The inner solve (:func:`_restricted_cd_f64`, every polish's).  The JAX
  package's residual form, its matvec-only contractions and its 1e-30 guards answer
  the TPU's emulated f64; on a card with native f64 a Python loop of
  per-coordinate ops would cost ~6 launches per coordinate visit.  The
  port runs its own block pass instead (``block_cd._active_pass`` with
  ``inner="exact"``, ``randomize=False``, every block active: K1 on the
  card) over the gathered float64 columns in blocks of 128 with cached
  Grams.  Exact Gauss-Seidel through the Gram recursion visits the same
  coordinates in the same order with the same closed-form update, so the
  iterates are the JAX package's up to rounding; the exact residual
  ``y − X_S β`` is recomputed at the end.  The sqrt polish runs the same
  pass with ``kind="sqrt"`` (K1's sqrt form in float64, exact inner):
  ``‖r‖²`` is refreshed exactly at every sweep's start and carried
  through the three-branch updates within it.
- The group polish's working-set Gram ``X_S'X_S`` and ``X_S'y`` are one
  float64 product of the gathered columns each.  The JAX package builds
  them column by column (``_gather_gram_f64``) because a TPU's emulated
  float64 accumulates exactly only in matrix-vector products; the H100
  multiplies float64 matrices natively.

The returned β is float64: the certificate belongs to the f64 iterate.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops.block_cd import (BlockedProblem, CDState, _active_pass,
                            _blockify_cols, _block_grams)
from ..ops.compensated import (_group_kkt_pieces, _sqrt_kkt_rel_from_grad,
                               _support_residual, check_col_chunk,
                               fenchel_gap_f64, grad_f64, host_f64,
                               loadings_f64, residual_f64)
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


def _restricted_sweeps(kind, prob, st, Xs, y64, lam0: float, tol: float,
                       max_sweeps: int = 400):
    """Sweep the restricted problem from ``st`` (every block active) until
    the largest coordinate step of a sweep is ≤ ``tol``; ``kind="sqrt"``
    refreshes ``‖r‖²`` exactly at each sweep's start.  Returns ``(st, beta
    (Cb,), r64, sweeps, maxh)`` with ``r64`` the exact residual of the
    final β, which the returned state carries too."""
    n = y64.shape[0]
    every = torch.ones_like(st.active)
    opts = CDOptions(inner="exact", randomize=False)
    sweeps, mx = 0, math.inf
    while mx > tol and sweeps < max_sweeps:
        if kind == "sqrt":
            st = st._replace(rsqr=torch.dot(st.r, st.r))
        st, maxh = _active_pass(kind, prob, st._replace(active=every), lam0,
                                float(n), False, opts)
        mx = host.item(maxh)
        sweeps += 1
    beta = st.beta.reshape(-1)
    # the exact residual of the FINAL β: the certificate must evaluate a
    # consistent (β, r) pair, not the incrementally updated one
    r64 = y64 - Xs @ beta
    return st._replace(r=r64), beta, r64, sweeps, mx


def _restricted_cd_f64(X, y64, lamw, idx, lam0: float, beta0, tol: float,
                       max_sweeps: int = 400, kind: str = "ls"):
    """Cyclic exact float64 coordinate descent on the working set ``idx``
    (see :func:`_restricted_problem`), least squares or (``kind="sqrt"``)
    the sqrt-lasso's three-branch minimizer.  Returns ``(beta (C,), r64
    (n,), sweeps, maxh)``."""
    C = idx.shape[0]
    prob, st, Xs = _restricted_problem(X, y64, lamw, idx, beta0)
    _, beta, r64, sweeps, mx = _restricted_sweeps(kind, prob, st, Xs, y64,
                                                  lam0, tol, max_sweeps)
    return beta[:C], r64, sweeps, mx


def _working_set(sup, beta_np, C: int, p: int):
    """Host index and start vectors of a working set of width ``C``: the
    support first, the pad slots at ``p`` (zero columns)."""
    idx_np = np.full((C,), p, np.int64)
    idx_np[:sup.size] = sup
    beta_s0 = np.zeros((C,), np.float64)
    beta_s0[:sup.size] = beta_np[sup]
    return idx_np, beta_s0


def _scatter(beta_s, idx_np, p: int):
    """The working set's coefficients as a dense host vector."""
    real = idx_np < p
    beta_np = np.zeros((p,), np.float64)
    beta_np[idx_np[real]] = host_f64(beta_s)[:idx_np.shape[0]][real]
    return beta_np


@host.spanned("polish.lasso")
def polish_lasso(X, y, beta, lam0, weights=None, *,
                 target_rel_gap: float = 1e-7, max_rounds: int = 6,
                 support_cap: int = 4096, col_chunk: int = 4096,
                 device=None) -> PolishResult:
    """Refine an (f32) Lasso solution ``beta`` at penalty ``lam0`` (per-
    coordinate ``weights``) to ``rel gap ≤ target_rel_gap``.  Runs on
    ``device`` (``None``: the GPU, raising when there is none; ``"cpu"``:
    the plain twins on the CPU).  If the support outgrows ``support_cap``
    the loop stops with ``converged=False`` and the gap of that iterate is
    still reported.  ``col_chunk`` is checked and ignored (the certificate's
    sweep is not chunked)."""
    check_col_chunk(col_chunk)
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
        with host.span("polish.certify"):
            g_np = host_f64(grad_f64(X, r64))
            gap, primal = fenchel_gap_f64(host_f64(r64), g_np, beta_full,
                                          lam0, w_np, n, yn, y2=y2)
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
        idx_np, beta_s0 = _working_set(sup, beta_np, C, p)
        with host.span("polish.restricted_solve"):
            beta_s, r64, _, _ = _restricted_cd_f64(
                X, y64, lamw, torch.as_tensor(idx_np, device=dev), lam0,
                torch.as_tensor(beta_s0, device=dev), tol_inner)
        beta_np = _scatter(beta_s, idx_np, p)
        g_np, gap, primal = certify(r64, beta_np)
        viol = np.maximum(np.abs(g_np) / n - lam0 * w_np, 0.0)
        viol[idx_np[idx_np < p]] = 0.0
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


# ---------------------------------------------------------------------------
# Sqrt-lasso polish
# ---------------------------------------------------------------------------


class SqrtPolishResult(NamedTuple):
    beta: torch.Tensor      # (p,) float64 polished coefficients
    kkt_rel: float          # compensated per-coordinate relative KKT
    norm_r: float           # ‖y − Xβ‖₂ of the polished iterate
    rounds: int
    support_size: int
    converged: bool         # kkt_rel <= target


def _sqrt_cert(X, r64, beta_np, lam0, w_np, sup):
    """Compensated sqrt-KKT certificate of a (β, exact r64) pair (the
    formulas of ``sqrt_lasso_kkt_compensated``).  Returns ``(kkt_rel, ‖r‖,
    g, t)``."""
    with host.span("polish.certify"):
        r_np = host_f64(r64)
        rn = float(np.sqrt(r_np @ r_np))
        t = np.maximum(lam0 * rn * w_np, 1e-300)
        g_np = host_f64(grad_f64(X, r64))
        return _sqrt_kkt_rel_from_grad(g_np, t, sup, beta_np), rn, g_np, t


@host.spanned("polish.sqrt_lasso")
def polish_sqrt_lasso(X, y, beta, lam0, weights=None, *,
                      target_kkt_rel: float = 1e-7, max_rounds: int = 6,
                      support_cap: int = 4096, col_chunk: int = 4096,
                      device=None) -> SqrtPolishResult:
    """Refine an (f32) sqrt-lasso solution to a compensated relative KKT
    residual ≤ ``target_kkt_rel`` (the sqrt-lasso analogue of
    ``polish_lasso``): an active-set loop with the exact three-branch
    float64 inner solve, certified against the whole design every round.
    ``col_chunk`` is checked and ignored (the certificate's sweep is not
    chunked).  Runs on ``device`` (``None``: the GPU, raising when there is
    none; ``"cpu"``: the plain twins on the CPU)."""
    check_col_chunk(col_chunk)
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

    sup = np.nonzero(beta_np)[0]
    C = _allocation(sup.size, p, support_cap)
    rounds = 0
    converged = False
    kkt = rn = float("nan")
    tol_inner = 1e-10 * max(1.0, float(np.max(np.abs(beta_np)) or 1.0))
    while True:
        if sup.size > min(support_cap, p):
            r64, sup_now = _support_residual(X, y, beta_np)
            kkt, rn, _, _ = _sqrt_cert(X, r64, beta_np, lam0, w_np, sup_now)
            break
        if sup.size > C:
            C = min(p, -(-sup.size // 128) * 128)
        idx_np, beta_s0 = _working_set(sup, beta_np, C, p)
        with host.span("polish.restricted_solve"):
            beta_s, r64, _, _ = _restricted_cd_f64(
                X, y64, lamw, torch.as_tensor(idx_np, device=dev), lam0,
                torch.as_tensor(beta_s0, device=dev), tol_inner, kind="sqrt")
        beta_np = _scatter(beta_s, idx_np, p)
        sup_now = np.nonzero(beta_np)[0]
        kkt, rn, g_np, t = _sqrt_cert(X, r64, beta_np, lam0, w_np, sup_now)
        rounds += 1
        if kkt <= target_kkt_rel:
            converged = True
            break
        if rounds >= max_rounds:
            break
        viol = np.maximum(np.abs(g_np) - t, 0.0) / t
        viol[idx_np[idx_np < p]] = 0.0
        extra = np.nonzero(viol > 0)[0]
        room = max(0, min(support_cap, p) - sup_now.size)
        extra = extra[np.argsort(-viol[extra])][: min(room, max(256, C))]
        new_sup = np.union1d(sup_now, extra)
        if new_sup.size == sup.size and np.array_equal(new_sup, sup):
            tol_inner = tol_inner / 10.0
        sup = new_sup

    return SqrtPolishResult(beta=torch.as_tensor(beta_np, device=dev),
                            kkt_rel=float(kkt), norm_r=float(rn),
                            rounds=rounds, support_size=int(sup.size),
                            converged=converged)


# ---------------------------------------------------------------------------
# Scaled-lasso polish: the float64 (β, σ) fixed point
# ---------------------------------------------------------------------------


class ScaledPolishResult(NamedTuple):
    beta: torch.Tensor
    sigma: float            # ‖r‖/√n of the final polished iterate
    gap: float              # duality gap of the final λ·σ lasso subproblem
    rel_gap: float
    primal: float
    rounds: int             # total inner polish rounds
    sigma_rounds: int
    sigma_rel_change: float  # |σ_new − σ_used| / σ_used at the last round
    converged: bool         # rel_gap ≤ target AND σ consistent


def _sigma_of(X, y, beta_np):
    """``‖y − Xβ‖/√n`` of a sparse host β, through its exact float64
    residual."""
    r_np = host_f64(_support_residual(X, y, beta_np)[0])
    return float(np.sqrt(r_np @ r_np / X.shape[0]))


def _restricted_set(X, y64, lamw, beta_np):
    """The settled support of ``beta_np`` plus 25 % slack as a restricted
    problem, or ``None`` when the support is empty.  Returns ``(prob, st,
    Xs, idx_np, sup)``."""
    p = X.shape[1]
    sup = np.nonzero(beta_np)[0]
    C = min(p, max(128, -(-int(1.25 * max(sup.size, 1)) // 128) * 128))
    if not (sup.size and sup.size <= C):
        return None
    idx_np, beta_s0 = _working_set(sup, beta_np, C, p)
    prob, st, Xs = _restricted_problem(
        X, y64, lamw, torch.as_tensor(idx_np, device=X.device),
        torch.as_tensor(beta_s0, device=X.device))
    return prob, st, Xs, idx_np, sup


@host.spanned("polish.scaled_lasso")
def polish_scaled_lasso(X, y, beta, lam, weights=None, *,
                        target_rel_gap: float = 1e-7,
                        sigma_rtol: float = 1e-7,
                        max_sigma_rounds: int = 12, device=None,
                        **polish_kw) -> ScaledPolishResult:
    """Polish a scaled-lasso solution to the float64 (β, σ) fixed point: β
    optimal (rel gap ≤ target) for the Lasso at λ·σ, σ = ‖y−Xβ‖/√n.  Each σ
    round is one warm ``polish_lasso`` at the current λ·σ; convergence
    needs both the subproblem's certificate and σ's self-consistency
    (``sigma_rtol``).  Between certifying rounds the (β_S, σ) alternation
    runs on the gathered support alone, collapsed by a scalar secant on
    ``h(σ) = ‖r(β(λσ))‖/√n − σ``; the next certifying round validates the
    off-set KKT at the final σ.  ``polish_kw`` goes to ``polish_lasso``.
    Runs on ``device`` as ``polish_lasso`` does."""
    dev = target_device(device)
    X = on_device(X, dev).contiguous()
    y = on_device(y, dev)
    n, p = X.shape
    y64 = y.to(torch.float64)
    beta_np = host_f64(beta)
    lam = float(lam)
    w_np = (np.ones((p,), np.float64) if weights is None
            else host_f64(weights))
    lamw = torch.as_tensor(w_np, device=dev)
    sig = _sigma_of(X, y, beta_np)
    rounds = 0
    res = None
    rel_change = float("nan")
    converged = False
    for sr in range(max_sigma_rounds):
        res = polish_lasso(X, y, beta_np, lam * sig, weights,
                           target_rel_gap=target_rel_gap, device=dev,
                           **polish_kw)
        beta_np = host_f64(res.beta)
        rounds += res.rounds
        signew = _sigma_of(X, y, beta_np)
        rel_change = abs(signew - sig) / max(sig, 1e-300)
        if res.converged and rel_change <= sigma_rtol:
            sig = signew
            converged = True
            break
        ws = _restricted_set(X, y64, lamw, beta_np)
        if ws is None:
            sig = signew
            continue
        prob, st, Xs, idx_np, _ = ws
        tol_in = 1e-10 * max(1.0, float(np.max(np.abs(beta_np)) or 1.0))
        sp = hp = None
        sig_i = signew
        for _ in range(40):
            with host.span("polish.restricted_solve"):
                st, beta_s, r64, _, _ = _restricted_sweeps(
                    "ls", prob, st, Xs, y64, lam * sig_i, tol_in)
            so = math.sqrt(host.item(torch.dot(r64, r64)) / n)
            hi = so - sig_i
            if abs(hi) / max(sig_i, 1e-300) <= 0.1 * sigma_rtol:
                sig_i = so
                break
            if hp is not None and hi != hp:
                nxt = sig_i - hi * (sig_i - sp) / (hi - hp)
                if not np.isfinite(nxt) or nxt <= 0:
                    nxt = so
            else:
                nxt = so
            sp, hp = sig_i, hi
            sig_i = nxt
        beta_np = _scatter(beta_s, idx_np, p)
        sig = sig_i
    return ScaledPolishResult(
        beta=torch.as_tensor(beta_np, device=dev), sigma=sig, gap=res.gap,
        rel_gap=res.rel_gap, primal=res.primal, rounds=rounds,
        sigma_rounds=sr + 1, sigma_rel_change=rel_change,
        converged=converged)


# ---------------------------------------------------------------------------
# Feasible-lasso polish: the float64 (β, Γ) loading fixed point
# ---------------------------------------------------------------------------


class FeasiblePolishResult(NamedTuple):
    beta: torch.Tensor
    loadings: torch.Tensor   # (p,) float64 loadings of the fixed point
    gap: float
    rel_gap: float
    primal: float
    rounds: int
    loading_rounds: int
    loading_rel_change: float
    converged: bool


def _ws_loadings(Xs, r64):
    """Working-set loadings ``sqrt(mean((X_ij r_i)²))`` over the gathered
    float64 columns ``Xs`` only: the cheap per-round update of the
    restricted (β_S, Γ_S) loop (pad slots are zero columns: loading 0)."""
    return torch.sqrt((r64 * r64) @ Xs.square() / Xs.shape[0])


@host.spanned("polish.feasible_lasso")
def polish_feasible_lasso(X, y, beta, lam0, *, target_rel_gap: float = 1e-7,
                          gamma_rtol: float = 1e-7,
                          max_loading_rounds: int = 12,
                          col_chunk: int = 2048, device=None,
                          **polish_kw) -> FeasiblePolishResult:
    """Polish a feasible (heteroscedastic) Lasso solution to the float64
    (β, Γ) fixed point: β optimal (rel gap ≤ target) for the weighted Lasso
    at (λ0, Γ), Γ_j = sqrt(mean((X_ij r_i)²)) from β's exact residual
    (``loadings_f64``).  Convergence needs the subproblem's certificate
    and the loading-stability rule ``max|ΔΓ|/maxΓ ≤ gamma_rtol``.  Between
    certifying rounds the (β_S, Γ_S) alternation runs on the gathered
    support alone; the next certifying round validates the off-set KKT at
    the final loadings.  ``polish_kw`` goes to ``polish_lasso``.  Runs on
    ``device`` as ``polish_lasso`` does."""
    dev = target_device(device)
    X = on_device(X, dev).contiguous()
    y = on_device(y, dev)
    n, p = X.shape
    y64 = y.to(torch.float64)
    beta_np = host_f64(beta)
    lam0 = float(lam0)

    def loadings(b_np):
        with host.span("polish.loadings"):
            return host_f64(loadings_f64(X, _support_residual(X, y, b_np)[0],
                                         col_chunk=col_chunk))

    gam = loadings(beta_np)
    rounds = 0
    res = None
    rel_change = float("nan")
    converged = False
    for lr in range(max_loading_rounds):
        with host.span("polish.loading_round"):
            res = polish_lasso(X, y, beta_np, lam0, gam,
                               target_rel_gap=target_rel_gap, device=dev,
                               **polish_kw)
            beta_np = host_f64(res.beta)
            rounds += res.rounds
            gam_new = loadings(beta_np)
            rel_change = float(np.max(np.abs(gam_new - gam))
                               / max(float(np.max(gam_new)), 1e-300))
            gam = gam_new
            if res.converged and rel_change <= gamma_rtol:
                converged = True
                break
            ws = _restricted_set(X, y64, torch.as_tensor(gam, device=dev),
                                 beta_np)
            if ws is None:
                continue
            prob, st, Xs, idx_np, sup = ws
            gam = np.array(gam, np.float64)                  # writable copy
            tol_in = 1e-10 * max(1.0, float(np.max(np.abs(beta_np)) or 1.0))
            gmax = max(float(np.max(gam)), 1e-300)
            for _ in range(40):
                with host.span("polish.restricted_solve"):
                    st, beta_s, r64, _, _ = _restricted_sweeps(
                        "ls", prob, st, Xs, y64, lam0, tol_in)
                gS = _ws_loadings(Xs, r64)
                dS = host.item(torch.max(torch.abs(gS - prob.lamw.reshape(-1))
                                         [:sup.size])) / gmax
                # the pad slots keep their weight 1 (zero columns, pinned at 0)
                lamw_s = prob.lamw.reshape(-1).clone()
                lamw_s[:sup.size] = gS[:sup.size]
                prob = prob._replace(lamw=lamw_s.reshape(prob.lamw.shape))
                if dS <= 0.1 * gamma_rtol:
                    break
            gam[sup] = host_f64(prob.lamw.reshape(-1)[:sup.size])
            beta_np = _scatter(beta_s, idx_np, p)
    return FeasiblePolishResult(
        beta=torch.as_tensor(beta_np, device=dev),
        loadings=torch.as_tensor(gam, device=dev), gap=res.gap,
        rel_gap=res.rel_gap, primal=res.primal, rounds=rounds,
        loading_rounds=lr + 1, loading_rel_change=rel_change,
        converged=converged)


# ---------------------------------------------------------------------------
# Group-lasso polish: float64 restricted block CD over the support groups
# ---------------------------------------------------------------------------


class GroupPolishResult(NamedTuple):
    beta: torch.Tensor      # (p,) float64 polished coefficients
    kkt_rel: float          # compensated per-group relative KKT
    rounds: int
    support_groups: int
    converged: bool         # kkt_rel <= target


def _gather_gram_f64(X, y, idx):
    """The working set's float64 Gram ``X_S'X_S`` and ``X_S'y`` (slots with
    ``idx == p`` are zero columns), one float64 product each, to the host
    in one counted read."""
    p = X.shape[1]
    C = idx.shape[0]
    valid = idx < p
    Xs = torch.where(valid[None, :], X.index_select(
        1, torch.clamp_max(idx, p - 1)).to(torch.float64), 0.0)
    Kc = host_f64(torch.cat([Xs.T @ Xs, (y.to(torch.float64) @ Xs)[None]]))
    return Kc[:C], Kc[C]


def _group_subproblem(Kgg, ct, t, b0):
    """Exact float64 solve of ``min ½ b'K b − c̃'b + t‖b‖₂`` (host NumPy).

    Zero if ``‖c̃‖ ≤ t``; otherwise ``(K + (t/s) I) b = c̃`` with
    ``s = ‖b‖``, i.e. in K's eigenbasis (``q = V'c̃``) the root of the
    strictly decreasing ``ψ(s) = Σ q_i²/(λ_i s + t)² − 1``, found by a
    safeguarded Newton iteration."""
    cn = float(np.linalg.norm(ct))
    if cn <= t:
        return np.zeros_like(b0)
    lam_e, V = np.linalg.eigh(Kgg)
    lam_e = np.maximum(lam_e, 0.0)
    q2 = (V.T @ ct) ** 2
    # bracket: ψ decreasing; s_hi from the smallest eigenvalue bound
    s = max(float(np.linalg.norm(b0)), (cn - t) / max(lam_e[-1], 1e-30))
    lo, hi = 0.0, (cn - t) / max(lam_e[0], 1e-30) if lam_e[0] > 0 else None
    if hi is None:
        # K_gg singular: ψ(s) → (q_null/t)² > 0 for every s if c̃ has mass
        # in the null space, so cap the bracket generously
        hi = max(s, 1.0) * 1e6
    s = min(max(s, 1e-12), hi)
    for _ in range(100):
        d = lam_e * s + t
        psi = float(np.sum(q2 / (d * d))) - 1.0
        if abs(psi) < 1e-15:
            break
        if psi > 0:
            lo = s
        else:
            hi = s
        dpsi = float(np.sum(-2.0 * lam_e * q2 / (d * d * d)))
        step = s - psi / dpsi if dpsi != 0 else 0.5 * (lo + hi)
        s = step if lo < step < hi else 0.5 * (lo + hi)
    return V @ ((V.T @ ct) / (lam_e + t / s))


def _group_bcd_host(K, c, t_sel, G, b0, tol, max_sweeps=400):
    """Cyclic exact block CD on the gathered float64 Gram (host NumPy):
    group g's subproblem gradient is ``c̃_g = c_g − (Kβ)_g + K_gg β_g``, and
    each visit solves it exactly (:func:`_group_subproblem`).  ``t_sel`` is
    the threshold of each selected group; groups are consecutive G-blocks
    of the gathered set.  Sweeps until the largest step is below ``tol``."""
    beta = b0.copy()
    kb = K @ beta
    for _ in range(max_sweeps):
        mx = 0.0
        for gi in range(t_sel.size):
            sl = slice(gi * G, (gi + 1) * G)
            Kgg = K[sl, sl]
            ct = c[sl] - kb[sl] + Kgg @ beta[sl]
            bnew = _group_subproblem(Kgg, ct, t_sel[gi], beta[sl])
            d = bnew - beta[sl]
            md = float(np.max(np.abs(d)))
            if md > 0:
                kb = kb + K[:, sl] @ d
                beta[sl] = bnew
                mx = max(mx, md)
        if mx < tol:
            break
    return beta


@host.spanned("polish.group_lasso")
def polish_group_lasso(X, y, beta, lam0, group_size: int, weights=None, *,
                       target_kkt_rel: float = 1e-7, max_rounds: int = 6,
                       group_cap: int = 512, col_chunk: int = 4096,
                       device=None) -> GroupPolishResult:
    """Refine an (f32) group-lasso solution to a compensated per-group
    relative KKT residual ≤ ``target_kkt_rel`` (objective
    ``‖y−Xβ‖²/(2n) + λ Σ_g ω_g ‖β_g‖₂``).  An active-set loop over groups:
    the selected groups' columns are gathered and their float64 Gram built
    on the device (:func:`_gather_gram_f64`); the restricted block CD runs
    in host NumPy float64 with exact per-group subproblem solves; every
    round is certified against the whole design
    (``ops.compensated._group_kkt_pieces``: K5 f64 on the card), and the
    most violating groups, at most 64 a round and ``group_cap`` in all,
    join the set.  A round that adds no group divides the inner tolerance
    by 10.  ``col_chunk`` is checked and ignored.  Runs on ``device``
    (``None``: the GPU, raising when there is none; ``"cpu"``: the plain
    twins on the CPU)."""
    check_col_chunk(col_chunk)
    dev = target_device(device)
    X = on_device(X, dev).contiguous()
    y = on_device(y, dev)
    n, p = X.shape
    G = int(group_size)
    ng = -(-p // G)
    lam0 = float(lam0)
    w_np = (np.ones((ng,), np.float64) if weights is None
            else host_f64(weights))
    t = np.maximum(n * lam0 * w_np, 1e-300)
    beta_np = host_f64(beta)
    gidx = np.arange(p) // G

    selg = np.unique(gidx[beta_np != 0])
    rounds = 0
    converged = False
    kkt = float("nan")
    tol_inner = 1e-11 * max(1.0, float(np.max(np.abs(beta_np)) or 1.0))
    while True:
        if selg.size > group_cap:
            with host.span("polish.certify"):
                kkt, _, _ = _group_kkt_pieces(X, y, beta_np, t, G)
            break
        if selg.size:
            # the selected groups' columns, a whole number of groups so the
            # host block slices stay aligned; the ragged tail group's
            # missing columns are zero slots
            cols = (selg[:, None] * G + np.arange(G)[None, :]).reshape(-1)
            idx_np = np.where(cols < p, cols, p).astype(np.int64)
            ok = idx_np < p
            b0 = np.where(ok, beta_np[np.minimum(idx_np, p - 1)], 0.0)
            with host.span("polish.restricted_solve"):
                K_np, c_np = _gather_gram_f64(
                    X, y, torch.as_tensor(idx_np, device=dev))
                beta_sel = _group_bcd_host(K_np, c_np, t[selg], G, b0,
                                           tol_inner)
            beta_np = np.zeros((p,), np.float64)
            beta_np[idx_np[ok]] = beta_sel[ok]
        # an empty set (cold start, or λ ≥ λmax) certifies β = 0 directly:
        # the roll-up seeds the first working set
        with host.span("polish.certify"):
            kkt, off_excess, _ = _group_kkt_pieces(X, y, beta_np, t, G)
        rounds += 1
        if kkt <= target_kkt_rel:
            converged = True
            break
        if rounds >= max_rounds:
            break
        viol = off_excess.copy()
        viol[selg] = 0.0
        extra = np.nonzero(viol > 0)[0]
        room = max(0, group_cap - selg.size)
        extra = extra[np.argsort(-viol[extra])][: min(room, 64)]
        sel_now = np.unique(gidx[beta_np != 0])
        new_selg = np.union1d(np.union1d(sel_now, selg), extra)
        if new_selg.size == selg.size and np.array_equal(new_selg, selg):
            tol_inner = tol_inner / 10.0
        selg = new_selg

    return GroupPolishResult(beta=torch.as_tensor(beta_np, device=dev),
                             kkt_rel=float(kkt), rounds=rounds,
                             support_groups=int(selg.size),
                             converged=converged)
