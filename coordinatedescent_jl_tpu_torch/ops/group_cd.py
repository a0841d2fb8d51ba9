"""Group-coordinate (atom) descent engine (counterpart of
``coordinatedescent_jl_tpu/ops/group_cd.py``; see that module's docstring
for the algorithm).  The solved problem is the group Lasso

    min_β loss(β) + λ0 Σ_g ω_g ‖β_g‖₂

over consecutive groups of ``G`` coordinates, for the least-squares,
weighted least-squares and sqrt-lasso losses.  The design is stored
column-blocked ``(nb, n, B)`` with ``B = k·G`` lanes holding ``k = ⌊128/G⌋``
whole groups (``B = G`` when ``G > 128``); every per-block Gram ``K_b`` and
its Gershgorin bound ``L_b`` are built once.  A block visit runs
``block_iters`` FISTA steps of the group prox-gradient on the block's joint
subproblem, then an exact per-group zero snap; convergence is declared only
by the order-independent group-KKT full sweep.

What differs from the JAX engine:

- Control flow runs on the host, as in ``ops/block_cd.py``: the epoch loop
  reads ``maxh`` once an epoch, the plain active pass reads the active mask
  once and loops over the active blocks only, the sqrt kind's MM loop reads
  its certificate once a round; every read is counted (``utils/host.py``).
- The FISTA momentum coefficients ``(t_k − 1)/t_{k+1}`` depend on no data:
  they are computed once on the host in the solve's dtype, so a visit reads
  nothing to the host.
- The full sweeps ``c = Xw'r`` (the full check and ``λmax``) go through the
  dense sweep kernel K5 (``kernels/gradient_sweep.py``) when the kernels
  are on, else its plain twin.  An active pass is one launch of the group
  pass kernel GP (``kernels/group_pass.py``) when the kernels are on and a
  block has at most 128 lanes, which walks the visit order on the device
  and reads nothing to the host; else the plain twin
  ``_group_active_pass_plain``, a host loop of eager visits (the JAX
  engine runs its visit outside any Pallas kernel).
- Visit orders for ``randomize=True`` come from a ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .block_cd import (_blockify_cols, _block_grams, _blocks_matvec, _eps,
                       _full_gradient_c, _np_dtype, _pad_to_blocks,
                       _to_blocked_beta, _weighted_rows, full_f32_matmuls,
                       noise_floor_mask)
from .losses import LeastSquaresLoss, SqrtLassoLoss, WeightedLSLoss
from .prox import ProxL1Group, fista_momentum, group_soft_threshold
from ..kernels import group_pass
from ..utils import host
from ..utils.helpers import on_device, sample_std, target_device
from ..utils.options import CDOptions, use_kernels


class GroupProblem(NamedTuple):
    """Group-blocked problem data (``k`` groups of width ``G`` per block,
    ``B = k·G`` lanes).  ``Xwb`` holds the row-weighted blocks
    ``diag(w)·X`` for the weighted loss and is the same tensor as ``Xb``
    otherwise: gradients are ``Xw'r``, Grams ``Xw'X``, residual updates use
    ``X``."""

    Xb: torch.Tensor      # (nb, n, B) column blocks
    Xwb: torch.Tensor     # (nb, n, B) row-weighted blocks (= Xb unless wls)
    Kb: torch.Tensor      # (nb, B, B) per-block Grams Xw_b'X_b
    y: torch.Tensor       # (n,)
    Lb: torch.Tensor      # (nb,) Gershgorin bound ≥ λmax(K_b)
    lamw: torch.Tensor    # (nb, k) per-group penalty weights (1 on padding)
    valid: torch.Tensor   # (nb, B) mask of real (unpadded) columns
    xwnorm: torch.Tensor  # (nb, B) ‖Xw_j‖, the f32 noise floor's scale


class GroupState(NamedTuple):
    """Solver state.  ``key`` is the ``torch.Generator`` of the randomized
    block orders; ``it``, ``conv`` and ``done`` are host values."""

    beta: torch.Tensor    # (nb, B)
    r: torch.Tensor       # (n,) residuals y − Xβ
    active: torch.Tensor  # (nb,) bool
    key: Optional[torch.Generator]
    it: int
    conv: bool
    done: bool


def _block_width(G: int) -> int:
    """Lanes per block: as many whole groups as fit 128 lanes (one group
    per block when G > 128)."""
    return G * max(1, 128 // G)


@host.spanned("group.build")
def _build_group_problem(X, y, lamw_g, G: int, w=None) -> GroupProblem:
    """Blocks of whole groups, zero-padded to ``nb·B`` columns (a ragged
    tail group and whole padded groups alike); padded groups take penalty
    weight 1.  The Grams come from one batched product."""
    n, p = X.shape
    B = _block_width(G)
    k = B // G
    ng = -(-p // G)
    Xp = _pad_to_blocks(X, B)
    Xb = _blockify_cols(Xp, B)
    nb = Xb.shape[0]
    Xwb = Xb if w is None else _blockify_cols(_weighted_rows(Xp, w), B)
    del Xp
    valid = (torch.arange(nb * B, device=X.device) < p).reshape(nb, B)
    Kb = _block_grams(Xwb, Xb)
    # Gershgorin row-sum bound ≥ λmax(K_b): an always-safe step for the
    # block's joint prox-gradient steps
    Lb = torch.amax(torch.sum(torch.abs(Kb), dim=2), dim=1)
    lamw_b = torch.nn.functional.pad(lamw_g, (0, nb * k - ng),
                                     value=1.0).reshape(nb, k)
    xwnorm = torch.linalg.vector_norm(Xwb, dim=1)
    return GroupProblem(Xb=Xb, Xwb=Xwb, Kb=Kb, y=y, Lb=Lb, lamw=lamw_b,
                        valid=valid, xwnorm=xwnorm)


def _group_prox(z, thr, k: int, G: int):
    """Group soft threshold over the (…, k·G) lane axis viewed as (k, G)
    groups; ``thr`` has a trailing (k,) axis."""
    shp = z.shape
    out = group_soft_threshold(z.reshape(shp[:-1] + (k, G)), thr[..., None])
    return out.reshape(shp)


def _block_visit(K, c0, beta0, L, thr, k: int, G: int, coefs):
    """FISTA proximal-gradient steps (one per entry of ``coefs``) on one
    block's joint subproblem with the group-separable prox.  Entering
    gradient ``c0 = Xw_b'r``; the running gradient at iterate ``b`` is
    ``c0 − K(b − beta0)`` (no X reads).  ``thr`` is the per-group prox
    level / L.  Then the exact per-group zero snap: a group whose solo
    optimum given the others is 0, ``‖c_g + K_gg·d_g‖ ≤ L·thr_g``, is set to
    0.  Returns ``(d, max|d − beta0|)``."""
    d = d_prev = beta0
    for coef in coefs:
        yv = torch.add(d, d - d_prev, alpha=coef)
        grad = torch.addmv(c0, K, yv - beta0, alpha=-1.0)
        d_prev, d = d, _group_prox(yv + grad / L, thr, k, G)
    q = torch.addmv(c0, K, d - beta0, alpha=-1.0)       # X'(r − XΔ)
    # each group's own contribution through the diagonal G×G blocks of K:
    # Kdiag[i, j, κ] = K[κG + i, κG + j];
    # own[κ, i] = Σ_j Kdiag[i, j, κ]·d[κ, j]
    Kdiag = torch.diagonal(K.reshape(k, G, k, G), dim1=0, dim2=2)
    own = torch.einsum("ijk,kj->ki", Kdiag, d.reshape(k, G))
    s = q.reshape(k, G) + own                            # c_g at d_g = 0
    solo_zero = torch.linalg.vector_norm(s, dim=1) <= L * thr
    d = torch.where(torch.repeat_interleave(solo_zero, G), 0.0, d)
    return d, torch.max(torch.abs(d - beta0))


def _group_active_pass(prob: GroupProblem, st: GroupState, lam0, n_scale,
                       randomize: bool, coefs, kernels: bool = False):
    """One Gauss-Seidel pass over the active blocks, ``k`` groups a visit:
    one launch of the group pass kernel when ``kernels`` (the mode rule's
    answer, ``use_kernels``) and a block has at most 128 lanes, reading
    nothing to the host; else :func:`_group_active_pass_plain`.  Both draw
    the randomized order from ``st.key`` alike."""
    nb, B = prob.valid.shape
    if not kernels or B > group_pass.MAX_B:
        return _group_active_pass_plain(prob, st, lam0, n_scale, randomize,
                                        coefs)
    dev = st.beta.device
    order = (torch.randperm(nb, generator=st.key).to(dev) if randomize
             else torch.arange(nb, device=dev))
    beta, r, maxh = group_pass.fused_group_pass(prob, st.beta, st.r,
                                                st.active, lam0, n_scale,
                                                order, coefs)
    return st._replace(beta=beta, r=r,
                       active=torch.any(beta != 0, dim=1)), maxh


def _group_active_pass_plain(prob: GroupProblem, st: GroupState, lam0,
                             n_scale, randomize: bool, coefs):
    """The plain twin of the group pass kernel: a host loop over the active
    blocks.  Reads the active mask to the host once; the visits read
    nothing."""
    nb, B = prob.valid.shape
    k = prob.lamw.shape[1]
    G = B // k
    order = (torch.randperm(nb, generator=st.key).tolist() if randomize
             else range(nb))
    act = host.tolist(st.active)
    beta = st.beta.clone()
    r = st.r
    maxh = torch.zeros((), dtype=beta.dtype, device=beta.device)
    for b in order:
        if not act[b]:
            continue
        c0 = torch.mv(prob.Xwb[b].T, r)
        L = torch.clamp_min(prob.Lb[b], 1e-30)
        thr = n_scale * lam0 * prob.lamw[b] / L
        b0 = beta[b]
        b1, mh = _block_visit(prob.Kb[b], c0, b0, L, thr, k, G, coefs)
        b1 = torch.where(prob.valid[b], b1, 0.0)
        r = r - torch.mv(prob.Xb[b], b1 - b0)
        beta[b] = b1
        maxh = torch.maximum(maxh, mh)
    return st._replace(beta=beta, r=r,
                       active=torch.any(beta != 0, dim=1)), maxh


def _full_sweep(prob: GroupProblem, r, kernels: bool):
    """``c = Xw'r`` for every block off the ``(nb, n, B)`` layout: the
    engine's dense sweep (K5 when the kernels are on, else its twin)."""
    return _full_gradient_c("ls", prob, r, kernels)


def _group_full_check(prob: GroupProblem, st: GroupState, lam0, n_scale,
                      opt_tol, kernels: bool):
    """Vectorized fixed-point sweep: one prox-gradient step per group from
    the current iterate, zero iff the group-KKT conditions hold (for
    β_g = 0: ‖Xw_g'r‖₂ ≤ n·λ0·ω_g; else Xw_g'r = n·λ0·ω_g·β_g/‖β_g‖).
    Blocks with a step ≥ tol are (re)activated."""
    k = prob.lamw.shape[1]
    G = prob.valid.shape[1] // k
    c = _full_sweep(prob, st.r, kernels)
    L = torch.clamp_min(prob.Lb, 1e-30)[:, None]
    thr = n_scale * lam0 * prob.lamw / L
    bstar = _group_prox(st.beta + c / L, thr, k, G)
    h = torch.where(prob.valid, bstar - st.beta, 0.0)
    # the f32 noise floor: the group step is c/L_b, so its gradient-noise
    # scale is κ·eps·‖Xw_j‖·‖r‖/L_b
    step_noise = None
    if st.beta.dtype.itemsize < 8:
        rnorm = torch.sqrt(torch.dot(st.r, st.r))
        step_noise = 4 * _eps(st.beta.dtype) * rnorm * prob.xwnorm / L
    habs = noise_floor_mask(torch.abs(h), st.beta, step_noise)
    viol = torch.any(habs >= opt_tol, dim=1)
    active = torch.any(st.beta != 0, dim=1) | viol
    return st._replace(active=active), torch.max(habs)


def _group_solve_at_lambda(opts: CDOptions, prob: GroupProblem, lam0,
                           st: GroupState, n_scale, coefs,
                           kernels: bool) -> GroupState:
    """Alternate full sweeps and active passes until two consecutive
    converged passes, the confirming one full; a stall detector (sub-f64
    dtypes only) stops a solve whose full-check maxH has not improved for
    ``stall_patience`` full checks.  One host read of ``maxh`` an epoch."""
    dtype = st.beta.dtype
    tol = float(_np_dtype(dtype).type(opts.opt_tol))
    patience = (opts.stall_patience if dtype.itemsize < 8
                else np.iinfo(np.int32).max)
    st = st._replace(it=0, conv=True, done=False)
    best = math.inf
    stall = 0
    while not st.done and st.it < opts.max_iter:
        host.COUNTS["epochs"] += 1
        was_full = st.conv
        with host.span("group.full_check" if was_full
                       else "group.active_pass"):
            if was_full:
                s2, maxh = _group_full_check(prob, st, lam0, n_scale,
                                             opts.opt_tol, kernels)
            else:
                s2, maxh = _group_active_pass(prob, st, lam0, n_scale,
                                              opts.randomize, coefs, kernels)
            maxh = host.item(maxh)
        conv = maxh < tol
        if was_full:
            stall = 0 if maxh < best else stall + 1
            best = min(best, maxh)
        done = (was_full and conv) or stall >= patience
        st = s2._replace(it=st.it + 1, conv=conv, done=done)
    return st


def _group_lambda_max(prob: GroupProblem, st: GroupState, n_scale,
                      kernels: bool):
    """Smallest λ0 with an all-zero solution, ``max_g ‖Xw_g'r‖₂ /
    (n·ω_g)`` at the current residual."""
    nb, B = prob.valid.shape
    k = prob.lamw.shape[1]
    c = _full_sweep(prob, st.r, kernels)
    cg = torch.where(prob.valid, c, 0.0).reshape(nb, k, B // k)
    nrm = torch.linalg.vector_norm(cg, dim=2)
    return torch.max(nrm / (n_scale * torch.clamp_min(prob.lamw, 1e-30)))


def _group_init(prob: GroupProblem, beta_g, key) -> GroupState:
    r = prob.y - _blocks_matvec(prob.Xb, beta_g)
    return GroupState(beta=beta_g, r=r, active=torch.any(beta_g != 0, dim=1),
                      key=key, it=0, conv=True, done=False)


@host.spanned("group.solve")
def _group_cd_core(X, y, lam0: float, lamw_g, beta0, key, G: int,
                   opts: CDOptions, w=None):
    """The ls / wls solve: warm from ``beta0``, or zero-start with
    log-spaced λ-continuation from the group λmax.  Returns ``(beta (p,),
    r)``."""
    n, p = X.shape
    dtype = X.dtype
    kernels = use_kernels(opts, X)
    prob = _build_group_problem(X, y, lamw_g, G, w)
    nb, B = prob.valid.shape
    coefs = fista_momentum(opts.block_iters, dtype)
    n_scale = float(n)
    if opts.warm_start:
        st = _group_solve_at_lambda(
            opts, prob, lam0, _group_init(prob, _to_blocked_beta(beta0, B),
                                          key), n_scale, coefs, kernels)
    else:
        st = _group_init(prob, torch.zeros((nb, B), dtype=dtype,
                                           device=X.device), key)
        npdt = _np_dtype(dtype)
        with host.span("group.lambda_max"):
            lammax = npdt.type(host.item(_group_lambda_max(prob, st, n_scale,
                                                           kernels)))
        # log-spaced schedule, num_steps + 1 points inclusive, in dtype
        lams = np.exp(np.linspace(np.log(lammax), np.log(npdt.type(lam0)),
                                  opts.num_steps + 1).astype(npdt)).tolist()
        for lam in lams:
            st = _group_solve_at_lambda(opts, prob, lam, st, n_scale, coefs,
                                        kernels)
    return st.beta.reshape(-1)[:p], st.r


@host.spanned("group.solve")
def _group_sqrt_core(X, y, lam0: float, lamw_g, beta0, key, G: int,
                     opts: CDOptions):
    """Group atoms × sqrt-lasso loss, ``min ‖y − Xβ‖₂ + λ0 Σ_g ω_g‖β_g‖``,
    by MM rounds: with ``ρ = ‖r‖`` fixed, one least-squares group solve
    with ``n_scale := ρ``, then a full check at the post-solve ρ certifies
    the round (its zero step means the sqrt group-KKT holds).  ρ stays on
    the device; one host read a round.  ``warm_start=False`` zeroes β
    first.  Returns ``(beta (p,), r)``."""
    p = X.shape[1]
    kernels = use_kernels(opts, X)
    prob = _build_group_problem(X, y, lamw_g, G, None)
    B = prob.valid.shape[1]
    coefs = fista_momentum(opts.block_iters, X.dtype)
    tol = float(_np_dtype(X.dtype).type(opts.opt_tol))
    if not opts.warm_start:
        beta0 = torch.zeros_like(beta0)
    st = _group_init(prob, _to_blocked_beta(beta0, B), key)

    def rho(s):
        return torch.sqrt(torch.clamp_min(torch.dot(s.r, s.r), 1e-30))

    it, done = 0, False
    while not done and it < opts.max_iter:
        st = _group_solve_at_lambda(opts, prob, lam0, st, rho(st), coefs,
                                    kernels)
        _, maxh = _group_full_check(prob, st, lam0, rho(st), opts.opt_tol,
                                    kernels)
        done = host.item(maxh) < tol
        it += 1
    return st.beta.reshape(-1)[:p], st.r


def group_coordinate_descent(beta0, loss, penalty: ProxL1Group,
                             options: CDOptions = CDOptions(), *,
                             seed: int = 0, key=None, device=None):
    """Minimize ``loss(β) + λ0 Σ_g ω_g ‖β_g‖₂`` over consecutive groups of
    ``penalty.group_size`` coordinates, for the least-squares, weighted
    least-squares and sqrt-lasso losses.  Returns ``(beta, residuals)``.
    ``key`` is an optional ``torch.Generator`` for the randomized block
    orders (default: one seeded with ``seed``).  Runs on ``device``
    (``None``: the GPU, raising when there is none; ``"cpu"`` for the plain
    path on the CPU), where the inputs are moved."""
    if isinstance(loss, WeightedLSLoss):
        kind = "wls"
    elif isinstance(loss, SqrtLassoLoss):
        kind = "sqrt"
    elif isinstance(loss, LeastSquaresLoss):
        kind = "ls"
    else:
        raise TypeError("group penalty supports the least-squares, "
                        "weighted-LS and sqrt-lasso losses")
    G = int(penalty.group_size)
    if G < 1:
        raise ValueError("group_size must be ≥ 1")
    dev = target_device(device)
    X = on_device(loss.X, dev)
    dtype = X.dtype
    p = X.shape[1]
    ng = -(-p // G)
    lamw_g = (torch.ones((ng,), dtype=dtype, device=dev)
              if penalty.weights is None
              else on_device(penalty.weights, dev, dtype))
    if tuple(lamw_g.shape) != (ng,):
        raise ValueError(f"group weight vector has shape "
                         f"{tuple(lamw_g.shape)}, expected ({ng},)")
    if tuple(beta0.shape) != (p,):
        raise ValueError("dimension mismatch between beta0 and loss")
    y = on_device(loss.y, dev, dtype)
    beta0 = on_device(beta0, dev, dtype)
    lam0 = float(_np_dtype(dtype).type(float(penalty.lam0)))
    if key is None:
        key = torch.Generator().manual_seed(seed)
    with full_f32_matmuls():
        if kind == "sqrt":
            return _group_sqrt_core(X, y, lam0, lamw_g, beta0, key, G,
                                    options)
        w = on_device(loss.w, dev, dtype) if kind == "wls" else None
        if w is not None and tuple(w.shape) != (X.shape[0],):
            raise ValueError("row weight vector has wrong length")
        return _group_cd_core(X, y, lam0, lamw_g, beta0, key, G, options, w)


@host.spanned("est.group_lasso")
def group_lasso(X, y, lam, group_size: int, weights=None,
                options: CDOptions = CDOptions(), *, seed: int = 0,
                device=None):
    """Group Lasso over consecutive equal-size groups,
    ``min ‖y−Xβ‖²/(2n) + λ Σ_g ω_g ‖β_g‖₂`` (``weights`` per group).
    Returns a ``LassoSolution`` like ``lasso``.  Runs on ``device`` as
    :func:`group_coordinate_descent` does."""
    from ..models.lasso import LassoSolution

    dev = target_device(device)
    X = on_device(X, dev)
    y = on_device(y, dev, X.dtype)
    g = ProxL1Group(float(lam), int(group_size),
                    None if weights is None else on_device(weights, dev,
                                                           X.dtype))
    beta0 = torch.zeros((X.shape[1],), dtype=X.dtype, device=dev)
    beta, r = group_coordinate_descent(beta0, LeastSquaresLoss(y, X), g,
                                       options, seed=seed, device=dev)
    return LassoSolution(beta, r, g, sample_std(r))
