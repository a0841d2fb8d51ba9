"""Block-coordinate-descent engine (counterpart of
``coordinatedescent_jl_tpu/ops/block_cd.py``; see that module's docstring
for the algorithm: column blocks ``Xb (nb, n, B)``, exact in-block
sequential CD through the Gram recursion, a vectorized KKT full check
with cached gradients, drift-ball certification and gap-safe screening,
and working-set compaction).  Four kinds, as there: ``ls``
(least squares), ``wls`` (row-weighted least squares, a second blocked
design ``Xwb``), ``sqrt`` (sqrt-lasso, the running ``‖r‖²`` in the state)
and ``quad`` (a quadratic ``x'Ax/2 + x'q`` whose blocks hold ``A``; plain
PyTorch only, no kernel takes it).

What differs from the JAX engine:

- Control flow runs on the host.  ``lax.while_loop``/``lax.scan`` are
  Python loops and ``lax.cond`` is an ``if`` on a value read from the
  device; every such read goes through ``utils/host.py`` and is counted.
  The reads are: the epoch's ``maxh``; ``n_need`` in each full check
  (it decides both "any refresh" and the dense switch); the coverage
  decision of each compaction round; ``n_active`` of each active pass.
- The kernel/plain choice (``_pallas_mode``/``_platform_dispatch`` in the
  JAX engine) is ``utils.options.use_kernels``: the hand-written CUDA
  kernels (``kernels/``) iff the tensors are on a CUDA device and
  ``use_pallas`` is not ``False``.
- Scalars that only steer control flow (``lam0``, ``n``, the λ grid,
  ``it``, ``conv``, ``done``, ``WsCache.ok``) are Python values.
- Visit orders for ``randomize=True`` come from a ``torch.Generator`` and
  cannot reproduce ``jax.random``.
- The design-read accounting (``count_x``, :class:`XCount`) counts in exact
  integers where the JAX engine accumulates in float32.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .losses import (LeastSquaresLoss, QuadraticLoss, SqrtLassoLoss,
                     WeightedLSLoss, num_coordinates)
from .prox import ProxL1, ProxL1Group, ProxZero, as_l1, soft_threshold
from .prox import sqrt_candidate as _sqrt_candidate
from ..utils import host
from ..utils.helpers import on_device, target_device
from ..utils.options import CDOptions, resolve_extrapolate, use_kernels

@contextlib.contextmanager
def full_f32_matmuls():
    """Pin full-f32 matrix products (no TF32) for the duration of a solve —
    the counterpart of the JAX engine's ``Precision.HIGHEST`` pins: TF32
    gradients cap the reachable KKT residual near 1e-3."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.set_float32_matmul_precision(prec)


def _eps(dtype) -> float:
    return torch.finfo(dtype).eps


def _np_dtype(dtype) -> np.dtype:
    """The numpy dtype of a torch floating dtype."""
    return np.dtype(str(dtype).replace("torch.", ""))


def _sqrt(x):
    return torch.sqrt(x) if isinstance(x, torch.Tensor) else math.sqrt(x)


def noise_floor_mask(habs, beta, step_noise=None):
    """Zero out per-coordinate steps below that coordinate's computational
    noise floor (sub-f64 dtypes only): iterate quantization
    ``2·eps·|β_j|`` plus the gradient accumulation noise ``step_noise``."""
    if beta.dtype.itemsize >= 8:
        return habs
    floor = 2 * _eps(beta.dtype) * torch.abs(beta)
    if step_noise is not None:
        floor = floor + step_noise
    return torch.where(habs <= floor, torch.zeros_like(habs), habs)


def _step_noise(r, xwnorm, dtype):
    """Per-coordinate f32 step-noise scale ``4·eps·‖r‖/‖Xw_j‖``."""
    if dtype.itemsize >= 8:
        return None
    rnorm = torch.sqrt(torch.dot(r, r))
    return 4 * _eps(dtype) * rnorm / torch.clamp_min(xwnorm, 1e-30)


# ---------------------------------------------------------------------------
# Blocked problem representation
# ---------------------------------------------------------------------------


class BlockedProblem(NamedTuple):
    """Column-blocked problem.  For ls/wls/sqrt: ``Xb (nb, n, B)`` the
    design, ``Xwb`` its row-weighted copy (the same tensor unless wls),
    ``y`` the response.  For quad: ``Xb (nb, P, B)`` holds the column
    blocks of ``A`` and ``q`` the linear term (``y``/``Xwb`` unused).
    ``adiag (nb, B)`` the curvatures (``Σ w X²``; ``A_jj`` for quad),
    ``lamw`` the blocked penalty weights, ``valid`` the mask of real
    (unpadded) columns, ``xwnorm`` ``‖Xw_j‖`` and ``Kb (nb, B, B)`` the
    optional cached per-block Grams ``Xw_b'X_b``."""

    Xb: torch.Tensor
    Xwb: Optional[torch.Tensor]
    y: Optional[torch.Tensor]
    q: Optional[torch.Tensor]
    adiag: torch.Tensor
    lamw: torch.Tensor
    valid: torch.Tensor
    xwnorm: torch.Tensor
    Kb: Optional[torch.Tensor] = None


class CDState(NamedTuple):
    """Solver state threaded through passes.  ``key`` is the
    ``torch.Generator`` of the randomized visit orders; ``it``, ``conv``
    and ``done`` are host values (they steer the host loop)."""

    beta: torch.Tensor    # (nb, B) blocked coefficients
    r: torch.Tensor       # residuals y - Xβ
    rsqr: torch.Tensor    # ‖r‖² running value (sqrt-lasso only; else 0)
    active: torch.Tensor  # (nb,) bool block mask
    key: Optional[torch.Generator]
    it: int
    conv: bool
    done: bool
    c: torch.Tensor       # (nb, B) cached gradient term Xw'r
    drift: torch.Tensor   # (nb,) bound on ‖r − r_ref[b]‖ since c[b]'s refresh


def _pad_to_blocks(v, B, fill=0.0):
    """``v`` with its last dimension padded to a multiple of ``B``; the
    padding of a design (2-D) is marked as a copy."""
    p = v.shape[-1]
    P = -(-p // B) * B
    if P == p:
        return v
    if v.dim() != 2:
        return torch.nn.functional.pad(v, (0, P - p), value=fill)
    with host.mark("design_copy", bytes=v.shape[0] * P * v.element_size()):
        return torch.nn.functional.pad(v, (0, P - p), value=fill)


def _blockify_cols(X, B):
    """(n, P) → (nb, n, B) contiguous column blocks (a copy, marked as
    such, unless the blocks are already laid out: one block)."""
    n, P = X.shape
    Xb = X.reshape(n, P // B, B).permute(1, 0, 2)
    if Xb.is_contiguous():
        return Xb
    with host.mark("design_copy", bytes=X.numel() * X.element_size()):
        return Xb.contiguous()


def _weighted_rows(Xp, w):
    """``diag(w)·X``, the wls design's copy (marked)."""
    with host.mark("design_copy", bytes=Xp.numel() * Xp.element_size()):
        return Xp * w[:, None]


@host.spanned("cd.build_blocked")
def build_blocked(kind: str, opts: CDOptions, lamw_full, *, X=None, y=None,
                  w=None, A=None, q=None):
    """Assemble the blocked problem: ``X``, ``y`` (and the row weights ``w``
    for wls), or ``A``, ``q`` for quad."""
    if kind not in ("ls", "wls", "sqrt", "quad"):
        raise ValueError(f"unknown kind {kind!r}")
    B = opts.block_size
    if kind == "quad":
        P0 = q.shape[0]
        dtype = q.dtype
        Ap = _pad_to_blocks(A, B)                          # pad cols
        Ap = _pad_to_blocks(Ap.T, B).T                     # pad rows
        qp = _pad_to_blocks(q, B)
        Xb = _blockify_cols(Ap, B)                         # (nb, P, B)
        nb = Xb.shape[0]
        adiag = torch.diagonal(Ap).reshape(nb, B)
        Xwb, yv = None, None
        xwnorm = torch.sqrt(torch.clamp_min(adiag, 0.0))   # unused for quad
    else:
        P0 = X.shape[1]
        dtype = X.dtype
        if kind == "wls":
            Xp = _pad_to_blocks(X, B)
            Xb = _blockify_cols(Xp, B)
            Xwb = _blockify_cols(_weighted_rows(Xp, w), B)
            adiag = torch.sum(Xwb * Xb, dim=1)             # Σ w X²
            xwnorm = torch.sqrt(torch.sum(Xwb * Xwb, dim=1))   # ‖w·X_j‖
        else:
            # the padded blocks and the X'X diagonal in one pass
            # (kernels/blockify.py; its plain twin unless the kernels are on)
            from ..kernels.blockify import blockify, blockify_plain
            Xb, adiag = (blockify if opts.use_pallas is not False
                         else blockify_plain)(X, B)
            Xwb = Xb
            xwnorm = torch.sqrt(torch.clamp_min(adiag, 0.0))
        nb = Xb.shape[0]
        yv, qp = y, None
    dev = Xb.device
    lamw_b = _pad_to_blocks(torch.as_tensor(lamw_full, device=dev).to(dtype),
                            B, fill=1.0).reshape(nb, B)
    valid = (torch.arange(nb * B, device=dev) < P0).reshape(nb, B)
    Kb = _block_grams(Xwb, Xb) if _gram_mode(kind, opts, nb, B, dtype) else None
    return BlockedProblem(Xb=Xb, Xwb=Xwb, y=yv, q=qp, adiag=adiag,
                          lamw=lamw_b, valid=valid, xwnorm=xwnorm, Kb=Kb)


def _gram_mode(kind, opts: CDOptions, nb: int, B: int, dtype=None) -> bool:
    """Decision for the per-block Gram cache (``CDOptions.cache_gram``):
    auto = on when the cache stays under 256 MiB and compaction will not
    engage (``dtype=None`` skips the compaction check, for sub-problems)."""
    if kind not in ("ls", "wls", "sqrt") or opts.cache_gram is False:
        return False
    if opts.cache_gram is True:
        return True
    if dtype is not None and _compact_nc(kind, opts, nb, B, dtype):
        return False
    itemsize = 4 if dtype is None else dtype.itemsize
    return nb * B * B * itemsize <= 256 * 1024 * 1024


def _block_grams(Xwb, Xb):
    """All per-block Grams ``K_b = Xw_b' X_b`` in one batched product."""
    return torch.bmm(Xwb.transpose(1, 2), Xb)


# ---------------------------------------------------------------------------
# Per-coordinate update rule
# ---------------------------------------------------------------------------


def _ls_candidate(beta, c, a, lam0, lamw, n_scale):
    """Closed-form (weighted) least-squares / quadratic coordinate minimizer
    ``prox(β + c/a; scale·λ0·λw/a)`` (``scale`` is n for ls/wls, 1 for
    quad); dead columns (``a ≤ 0``) keep β.  The sqrt kind's is
    ``_sqrt_candidate`` (``ops/prox.py::sqrt_candidate``, shared
    with K1's plain twin)."""
    safe = a > 0
    asafe = torch.where(safe, a, torch.ones_like(a))
    z = beta + c / asafe
    val = soft_threshold(z, n_scale * lam0 * lamw / asafe)
    return torch.where(safe, val, beta)


# ---------------------------------------------------------------------------
# Active pass
# ---------------------------------------------------------------------------


def _visit_block(kind, K, beta_b, lamw_b, lam0, c, rsqr, n_scale, order):
    """Sequentially minimize each coordinate of one block (``order`` a
    host list); after coordinate ``i`` moves by ``h`` every remaining
    gradient shifts by ``K[:, i]·h``.  For sqrt the running ``‖r‖²`` is
    threaded through.  Returns ``(beta_b, rsqr, maxh)``."""
    a_diag = torch.diagonal(K)
    beta_b = beta_b.clone()
    maxh = torch.zeros((), dtype=beta_b.dtype, device=beta_b.device)
    for i in order:
        bi = beta_b[i].clone()
        a = a_diag[i]
        if kind == "sqrt":
            val, s, rsb = _sqrt_candidate(bi, c[i], a, rsqr, lam0, lamw_b[i])
            rsqr = torch.clamp_min(rsb - 2.0 * val * s + val * val * a, 0.0)
        else:
            val = _ls_candidate(bi, c[i], a, lam0, lamw_b[i], n_scale)
        h = val - bi
        c = c - K[:, i] * h
        beta_b[i] = val
        maxh = torch.maximum(maxh, torch.abs(h))
    return beta_b, rsqr, maxh


def _inner(opts: CDOptions, dtype) -> str:
    if opts.inner != "auto":
        return opts.inner
    return "ista" if dtype.itemsize < 8 else "exact"


def _active_pass(kind, prob: BlockedProblem, st: CDState, lam0, n_scale,
                 randomize: bool, opts: Optional[CDOptions] = None):
    """One pass over the active blocks.  Runs the fused active-pass kernel
    (``kernels/active_pass.py``; the residual kinds ls, wls and sqrt, with
    ``rsqr`` in and out) when the mode rule allows it, else the plain
    exact-scan pass (always for quad)."""
    nb, B = prob.lamw.shape
    dev = st.beta.device
    if randomize:
        border = torch.randperm(nb, generator=st.key).to(dev)
        corder = torch.randperm(B, generator=st.key).to(dev)
    else:
        border = torch.arange(nb, device=dev)
        corder = torch.arange(B, device=dev)

    if (opts is not None and kind in ("ls", "wls", "sqrt")
            and use_kernels(opts, st.beta)):
        from ..kernels.active_pass import fused_active_pass

        beta2, r2, maxh, rsqr2 = fused_active_pass(
            prob, st.beta, st.r, st.active, lam0, n_scale, border, corder,
            kind=kind, rsqr=st.rsqr, inner=_inner(opts, st.beta.dtype),
            iters=opts.block_iters)
        st2 = st._replace(beta=beta2, r=r2, rsqr=rsqr2,
                          active=torch.any(beta2 != 0, dim=1))
    else:
        st2, maxh = _xla_active_pass(kind, prob, st, lam0, n_scale, border,
                                     corder)
    # every cached gradient block goes stale by at most ‖Δr‖
    dnorm = torch.sqrt(torch.sum((st2.r - st.r) ** 2))
    return st2._replace(drift=st.drift + dnorm), maxh


def _xla_active_pass(kind, prob: BlockedProblem, st: CDState, lam0, n_scale,
                     border, corder):
    """Plain active pass: per-block Gram product + sequential in-block scan
    + residual update (the reference-exact path).  Reads the active mask
    and the visit orders to the host once."""
    nb, B = prob.lamw.shape
    flat = host.tolist(torch.cat([st.active.to(torch.int64),
                                  border.to(torch.int64),
                                  corder.to(torch.int64)]))
    act, border_h, corder_h = flat[:nb], flat[nb:2 * nb], flat[2 * nb:]
    beta = st.beta.clone()
    r = st.r
    rsqr = st.rsqr
    maxh = torch.zeros((), dtype=beta.dtype, device=beta.device)
    for b in border_h:
        if not act[b]:
            continue
        G = prob.Xb[b]
        if kind == "quad":
            # the block's rows of A are its Gram; r caches Ax
            K = G[b * B:(b + 1) * B]
            c = -(r[b * B:(b + 1) * B] + prob.q[b * B:(b + 1) * B])
        else:
            Gw = prob.Xwb[b]
            K = prob.Kb[b] if prob.Kb is not None else Gw.T @ G
            c = Gw.T @ r
        bb = beta[b].clone()
        bb2, rsqr, mh = _visit_block(kind, K, bb, prob.lamw[b], lam0, c,
                                     rsqr, n_scale, corder_h)
        h = bb2 - bb
        r = r + G @ h if kind == "quad" else r - G @ h
        beta[b] = bb2
        maxh = torch.maximum(maxh, mh)
    return st._replace(beta=beta, r=r, rsqr=rsqr,
                       active=torch.any(beta != 0, dim=1)), maxh


# ---------------------------------------------------------------------------
# Full check
# ---------------------------------------------------------------------------


def _full_gradient_c(kind, prob: BlockedProblem, r, kernels: bool):
    """Blocked ``c = Xw'r`` for every coordinate at once: the dense sweep
    kernel K5 (``kernels/gradient_sweep.py``) when the kernels are on, else
    its plain twin, one batched product straight off the (nb, n, B)
    layout.  Quad: ``−(Ax + q)`` from the maintained ``Ax``, O(p)."""
    if kind == "quad":
        nb, B = prob.lamw.shape
        return -(r.reshape(nb, B) + prob.q.reshape(nb, B))
    from ..kernels.gradient_sweep import (fused_gradient_sweep,
                                          fused_gradient_sweep_plain)

    if kernels:
        return fused_gradient_sweep(prob.Xwb, r)
    return fused_gradient_sweep_plain(prob.Xwb, r)


def _blocks_matvec(Xb, beta_b):
    """``Σ_b Xb[b] @ beta_b[b]`` — ``X β`` from the blocked layout, without
    copying it (see ``_full_gradient_c``)."""
    return torch.bmm(Xb, beta_b[:, :, None]).sum(dim=0)[:, 0]


def _potential_steps(kind, prob, beta, c, rsqr, lam0, n_scale):
    """Jacobi-style per-coordinate optimal displacement given the full
    gradient — the order-independent optimality residual."""
    if kind == "sqrt":
        val, _, _ = _sqrt_candidate(beta, c, prob.adiag, rsqr, lam0,
                                    prob.lamw)
    else:
        val = _ls_candidate(beta, c, prob.adiag, lam0, prob.lamw, n_scale)
    return torch.where(prob.valid, val - beta, torch.zeros_like(beta))


def _habs_reduce_core(h, bound, use_bound2, cand2, beta, xwnorm, rn2,
                      opt_tol):
    """f32 tail of the full check: bound substitution for certified-stale
    blocks, screened-block zeroing, the per-coordinate noise floor, and
    the maxH / block-activation reductions.  ``use_bound2``/``cand2`` are
    ``(nb, 1)`` bool; returns ``(maxh, active (nb, 1) bool)``."""
    eps = _eps(beta.dtype)
    zero = torch.zeros_like(h)
    habs = torch.abs(h)
    habs = torch.where(use_bound2, bound, habs)
    habs = torch.where(cand2, habs, zero)
    sn = 4.0 * eps * _sqrt(rn2) / torch.clamp_min(xwnorm, 1e-30)
    floor = 2.0 * eps * torch.abs(beta) + sn
    habs = torch.where(habs <= floor, zero, habs)
    maxh = torch.max(habs)
    viol2 = torch.any(habs >= opt_tol, dim=1, keepdim=True)
    nz2 = torch.any(beta != 0, dim=1, keepdim=True)
    return maxh, nz2 | viol2


def _gap_safe_core(c, beta, drift2, adiag, lamw, valid, lam0, n_scale,
                   rn2, ry):
    """Gap-safe screen on the cached gradients (see the JAX engine's
    ``_gap_safe_candidates`` for the derivation).  ``drift2`` is the
    per-block drift as ``(nb, 1)``; returns the candidate mask ``(nb, 1)``."""
    eps = _eps(beta.dtype)
    zero = torch.zeros_like(c)
    xnorm = torch.sqrt(torch.clamp_min(adiag, 0.0))
    c_slack = xnorm * _sqrt(rn2) * (8.0 * _sqrt(n_scale) * eps)
    u = torch.abs(c) + xnorm * drift2 + c_slack
    lamvec = n_scale * lam0 * lamw
    pos = valid & (lamvec > 0)
    ratio_ub = torch.max(torch.where(pos, u, zero)
                         / torch.where(pos, lamvec, torch.ones_like(c)))
    ok = ~torch.any(valid & ~(lamvec > 0))
    scale = torch.clamp(1.0 / torch.clamp_min(ratio_ub, 1e-30), max=1.0)
    primal = rn2 / (2.0 * n_scale) + lam0 * torch.sum(
        torch.where(valid, lamw * torch.abs(beta), zero))
    dual = (2.0 * scale * ry - scale * scale * rn2) / (2.0 * n_scale)
    gap = (torch.clamp_min(primal - dual, 0.0)
           + 64.0 * eps * (torch.abs(primal) + torch.abs(dual)))
    rho = torch.sqrt(2.0 * n_scale * gap)
    screened = (ok & pos & (beta == 0)
                & (scale * u + rho * xnorm < lamvec * (1.0 - 8.0 * eps)))
    return torch.any(valid & ~screened, dim=1, keepdim=True)


def _gap_safe_candidates(prob: BlockedProblem, st: CDState, lam0, n_scale,
                         rn2):
    """Per-block candidate mask (blocks NOT provably all-zero at this λ's
    optimum)."""
    ry = torch.dot(st.r, prob.y)
    return _gap_safe_core(st.c, st.beta, st.drift[:, None], prob.adiag,
                          prob.lamw, prob.valid, lam0, n_scale, rn2,
                          ry)[:, 0]


def _stale_core_ls(c, beta, drift2, adiag, lamw, valid, xwnorm, lam0,
                   n_scale, opt_tol):
    """Drift-ball certification without refreshing ``c``: ``|h_exact| ≤
    |h(c_stale)| + ‖Xw_j‖·drift[b]/a``.  Returns ``(certified (nb, 1),
    bound (nb, B), h_stale (nb, B))``."""
    zero = torch.zeros_like(c)
    dball = drift2 * (1.0 + 64.0 * _eps(beta.dtype))
    e_c = xwnorm * dball
    val = _ls_candidate(beta, c, adiag, lam0, lamw, n_scale)
    h_stale = torch.where(valid, val - beta, zero)
    asafe = torch.where(adiag > 0, adiag, torch.ones_like(adiag))
    bound = torch.abs(h_stale) + e_c / asafe
    bound = torch.where(valid, bound, zero)
    certified2 = ~torch.any(~(bound < opt_tol), dim=1, keepdim=True)
    return certified2, bound, h_stale


def _stale_certified(kind, prob: BlockedProblem, st: CDState, rsqr, lam0,
                     n_scale, opt_tol):
    """Per-block certificate that every potential step is < ``opt_tol``
    without refreshing the cached gradient.  For sqrt only all-zero blocks
    certify, through the exact zero condition ``|X_j'r| ≤ λ0·λw_j·‖r‖``
    bounded from above with the staleness ball.  Returns ``(certified
    (nb,), bound (nb, B))``."""
    if kind != "sqrt":
        certified2, bound, _ = _stale_core_ls(
            st.c, st.beta, st.drift[:, None], prob.adiag, prob.lamw,
            prob.valid, prob.xwnorm, lam0, n_scale, opt_tol)
        return certified2[:, 0], bound
    dball = st.drift[:, None] * (1.0 + 64.0 * _eps(st.beta.dtype))
    e_c = prob.xwnorm * dball
    zero_blk = ~torch.any(st.beta != 0, dim=1)
    thr = lam0 * prob.lamw * torch.sqrt(torch.clamp_min(rsqr, 0.0))
    ok = (torch.abs(st.c) + e_c) <= thr
    bound = torch.where(ok & zero_blk[:, None], 0.0, math.inf).to(st.c.dtype)
    bound = torch.where(prob.valid, bound, torch.zeros_like(bound))
    return torch.all(bound < opt_tol, dim=1), bound


def _refresh_c(kind, prob: BlockedProblem, st: CDState, need, n_need: int,
               kernels: bool):
    """Refresh the cached gradient for the ``need`` blocks.  The dense sweep
    (K5, or its plain twin when the kernels are off) when the kernels are
    off or every block refreshes; otherwise the restricted sweep kernel
    (K2), which reads only the needed blocks.  The JAX package switches
    above 0.8 of the blocks; on the H100 K2 stays below the dense branch
    up to every block, where the two tie (PERF.md, the K2/K5 crossover)."""
    nb = prob.lamw.shape[0]
    if not kernels or n_need == nb:
        return torch.where(need[:, None],
                           _full_gradient_c(kind, prob, st.r, kernels), st.c)
    from ..kernels.gradient_sweep import restricted_gradient_sweep

    return restricted_gradient_sweep(prob.Xwb, st.r, need, st.c,
                                     n_need=n_need)


def _check_scalars(lam0, n_scale, rn2, ry, opt_tol):
    """The check kernels' scalar row ``[λ0, n, ‖r‖², r'y, tol]``, built on
    the device without a host round trip (``fill_`` passes a Python float
    to a kernel; ``scal[i] = float`` would copy it from the host and
    synchronise)."""
    scal = rn2.new_empty((5,))
    scal[0].fill_(lam0)
    scal[1].fill_(n_scale)
    scal[2].copy_(rn2)
    scal[3].copy_(ry)
    scal[4].fill_(opt_tol)
    return scal


def _fused_full_check(kind, prob: BlockedProblem, st: CDState, lam0,
                      n_scale, opt_tol, rsqr, screen, xc=None):
    """Fused execution of the ls/wls full check (f32): check
    phase A evaluates the whole no-refresh check and the ``need`` mask;
    when some block needs a refresh, the gradient is refreshed
    (``_refresh_c``) and phase B re-evaluates the steps with it.  The
    phase wrappers (``kernels/check.py``) launch the kernels for CUDA
    tensors and run their plain twins for CPU tensors.  ``xc`` (an
    :class:`XCount` or ``None``) counts the refreshed blocks' reads."""
    from ..kernels.check import check_phase_a, check_phase_b

    dt = st.beta.dtype
    rn2 = torch.dot(st.r, st.r)
    ry = torch.dot(st.r, prob.y) if screen else torch.zeros_like(rn2)
    scal = _check_scalars(lam0, n_scale, rn2, ry, opt_tol)
    validf = prob.valid.to(dt)
    needf, ubf, candf, bound, maxh, activef = check_phase_a(
        st.c, st.beta, st.drift, prob.adiag, prob.lamw, validf,
        prob.xwnorm, scal, screen=screen)
    need = needf > 0
    n_need = host.item(torch.sum(need))
    if xc is not None:
        xc.add(n_need * prob.y.shape[0] * prob.lamw.shape[1])
    c = st.c
    if n_need:
        c = _refresh_c(kind, prob, st, need, n_need, True)
        maxh, activef = check_phase_b(c, st.beta, bound, ubf, candf,
                                      prob.adiag, prob.lamw, validf,
                                      prob.xwnorm, scal)
    drift_new = torch.where(need, torch.zeros_like(st.drift), st.drift)
    return st._replace(rsqr=rsqr, active=activef > 0, c=c,
                       drift=drift_new), maxh


def _full_check(kind, prob: BlockedProblem, st: CDState, lam0, n_scale,
                opt_tol, opts: Optional[CDOptions] = None, *, xc=None):
    """Vectorized full pass: KKT sweep + (re)activation of violating blocks,
    reading X only for stale, uncertified, unscreened blocks.  ``xc`` (an
    :class:`XCount` or ``None``) counts what the check reads of the design:
    ``n·B`` elements for each refreshed block, none for the cached-exact,
    drift-certified and screened ones, none for quad (JAX block_cd.py
    :775-778, :870-879)."""
    # sqrt: refresh the exact ‖r‖² (the zero threshold λ·√rsqr inherits
    # its accuracy)
    rsqr = torch.dot(st.r, st.r) if kind == "sqrt" else st.rsqr
    nb, B = prob.lamw.shape
    dev = st.beta.device
    if kind == "quad":
        # the gradient term is O(p) from the maintained Ax: recompute
        c = _full_gradient_c(kind, prob, st.r, False)
        drift_new = torch.zeros_like(st.drift)
        cand = torch.ones((nb,), dtype=torch.bool, device=dev)
        use_bound = torch.zeros((nb,), dtype=torch.bool, device=dev)
        bound = torch.zeros_like(st.c)
    else:
        # the gap-safe screen is the least-squares Lasso's; the fused check
        # kernels hold the ls/wls formulas in f32
        screen = (kind == "ls" and opts is not None
                  and opts.screen is not False)
        kernels = opts is not None and use_kernels(opts, st.beta)
        if (kind in ("ls", "wls") and kernels
                and opts.fuse_check is not False
                and st.beta.dtype == torch.float32):
            return _fused_full_check(kind, prob, st, lam0, n_scale, opt_tol,
                                     rsqr, screen, xc)

        if screen:
            rn2 = torch.dot(st.r, st.r)
            cand = _gap_safe_candidates(prob, st, lam0, n_scale, rn2)
        else:
            cand = torch.ones((nb,), dtype=torch.bool, device=dev)
        stale = st.drift > 0
        certified, bound = _stale_certified(kind, prob, st, rsqr, lam0,
                                            n_scale, opt_tol)
        need = cand & stale & ~certified
        use_bound = stale & certified
        n_need = host.item(torch.sum(need))
        if xc is not None:
            xc.add(n_need * prob.y.shape[0] * B)
        c = (_refresh_c(kind, prob, st, need, n_need, kernels) if n_need
             else st.c)
        drift_new = torch.where(need, torch.zeros_like(st.drift), st.drift)

    h = _potential_steps(kind, prob, st.beta, c, rsqr, lam0, n_scale)
    habs = torch.abs(h)
    habs = torch.where(use_bound[:, None], bound, habs)
    habs = torch.where(cand[:, None], habs, torch.zeros_like(habs))
    # quad's state caches Ax, not a residual: only the iterate term
    habs = noise_floor_mask(
        habs, st.beta,
        None if kind == "quad" else _step_noise(st.r, prob.xwnorm,
                                                st.beta.dtype))
    maxh = torch.max(habs)
    viol = torch.any(habs >= opt_tol, dim=1)
    active = torch.any(st.beta != 0, dim=1) | viol
    return st._replace(rsqr=rsqr, active=active, c=c, drift=drift_new), maxh


# ---------------------------------------------------------------------------
# Working-set compaction
# ---------------------------------------------------------------------------


def _compact_mode(kind, opts: CDOptions, prob: BlockedProblem, dtype) -> int:
    """Number of working-set blocks ``nc`` (0 = compaction off)."""
    nb, B = prob.lamw.shape
    return _compact_nc(kind, opts, nb, B, dtype)


def _compact_nc(kind, opts: CDOptions, nb: int, B: int, dtype) -> int:
    """Shape-level core of :func:`_compact_mode`: on when forced, or (auto)
    for sub-f64 dtypes when ``nb ≥ 4·nc``."""
    if kind not in ("ls", "wls", "sqrt") or opts.compact is False:
        return 0
    nc = -(-opts.compact_size // B)
    if nc + 1 > nb:
        return 0
    if opts.compact is True:
        return nc
    return nc if (dtype.itemsize < 8 and nb >= 4 * nc) else 0


class WsCache(NamedTuple):
    """Persistent working-set cache for compaction: ``idx`` the gathered
    coordinates (sorted), ``Xb`` the gathered column blocks ``(nc, n, B)``,
    ``Xwb`` their row-weighted copy (wls only, else ``None``), ``ok``
    (host bool) whether it holds a real gather, ``Kb`` their Grams."""

    idx: torch.Tensor
    Xb: torch.Tensor
    Xwb: Optional[torch.Tensor]
    ok: bool
    Kb: Optional[torch.Tensor] = None


def _empty_ws_cache(kind, prob: BlockedProblem, nc: int,
                    opts: CDOptions) -> WsCache:
    n = prob.y.shape[0]
    B = prob.lamw.shape[1]
    like = dict(dtype=prob.Xb.dtype, device=prob.Xb.device)
    gram = _gram_mode(kind, opts, nc, B)
    return WsCache(idx=torch.zeros((nc * B,), dtype=torch.int64,
                                   device=prob.Xb.device),
                   Xb=torch.zeros((nc, n, B), **like),
                   Xwb=(torch.zeros((nc, n, B), **like) if kind == "wls"
                        else None), ok=False,
                   Kb=torch.zeros((nc, B, B), **like) if gram else None)


def secant_alpha(x_new, x_k, x_km1, dtype):
    """Clipped secant ratio ``(x_new − x_k)/(x_k − x_km1)`` in ``dtype``
    arithmetic, as a Python float: 0 when the two previous abscissae
    coincide, clipped to [0, 2]."""
    npdt = _np_dtype(dtype)
    x_new, x_k, x_km1 = (npdt.type(v) for v in (x_new, x_k, x_km1))
    denom = x_k - x_km1
    if denom == 0:
        return 0.0
    return float(np.clip((x_new - x_k) / denom, 0.0, 2.0))


def _extrapolate_path_start(st: CDState, cache: WsCache, beta_prev,
                            lam_k, lam_km1, lam_new):
    """Secant extrapolation of the warm start along a λ path, using only
    the cached working-set columns for the residual update; skipped when
    the shift leaves the working set (it is an accelerant only)."""
    nb, B = st.beta.shape
    nc = cache.Xb.shape[0]
    alpha = secant_alpha(lam_new, lam_k, lam_km1, st.beta.dtype)
    if not (cache.ok and alpha > 0):
        return st
    zero = torch.zeros_like(st.beta)
    delta = torch.where(st.beta != 0, st.beta - beta_prev, zero)
    member = _member(cache.idx, nb, B)
    if host.item(torch.any((delta != 0) & ~member)):
        return st
    d = alpha * delta
    dws = d[cache.idx // B, cache.idx % B].reshape(nc, B)
    dr = -_blocks_matvec(cache.Xb, dws)
    beta2 = st.beta + d
    dnorm = torch.sqrt(torch.sum(dr * dr))
    return st._replace(beta=beta2, r=st.r + dr,
                       active=torch.any(beta2 != 0, dim=1),
                       drift=st.drift + dnorm)


def _member(idx, nb, B):
    member = torch.zeros((nb * B,), dtype=torch.bool, device=idx.device)
    return member.index_fill_(0, idx, True).reshape(nb, B)


def _ws_cache_from_idx(kind, prob: BlockedProblem, nc: int,
                       opts: CDOptions, idx, ok: bool) -> WsCache:
    """(Re)build a working-set cache from a coordinate index set."""
    B = prob.lamw.shape[1]
    bi, li = idx // B, idx % B

    def grab(Ab):
        g = Ab[bi, :, li]                             # (C, n)
        return g.reshape(nc, B, -1).transpose(1, 2).contiguous()

    Xb = grab(prob.Xb)
    Xwb = grab(prob.Xwb) if kind == "wls" else None
    Kb = (_block_grams(Xb if Xwb is None else Xwb, Xb)
          if _gram_mode(kind, opts, nc, B) else None)
    return WsCache(idx=idx, Xb=Xb, Xwb=Xwb, ok=ok, Kb=Kb)


def _compact_pass(kind, prob: BlockedProblem, st: CDState, lam0, n_scale,
                  opts: CDOptions, nc: int, cache: WsCache, *, xc=None):
    """One working-set round: solve the dense ``(n, C)`` subproblem over the
    top-``C`` priority coordinates (support first, then the largest
    stale-KKT steps) and scatter the result back; falls back to the
    ordinary active pass when the working set cannot hold the support.
    Returns ``(state, maxh, cache)``; ``maxh`` is 0.0 for a compact round
    so the next pass is the confirming full check.  ``xc`` (an
    :class:`XCount` or ``None``) counts the design reads: ``C·n`` for a
    gather that is not a reuse plus the inner solve's own reads of the
    gathered copy, or ``Σactive·n·B`` for the dense fallback (JAX
    block_cd.py:1138-1163)."""
    nb, B = prob.lamw.shape
    C = nc * B
    dt = st.beta.dtype

    h = _potential_steps(kind, prob, st.beta, st.c, st.rsqr, lam0, n_scale)
    habs = torch.where(prob.valid, torch.abs(h), torch.zeros_like(h))
    required = (st.beta != 0) | (habs >= opts.opt_tol)
    covered_t = ~torch.any(required & ~_member(cache.idx, nb, B))
    room_t = torch.sum(st.beta != 0) <= C - B
    covered, room = host.tolist(torch.stack([covered_t, room_t]))
    reuse = cache.ok and covered
    use = (reuse or room) and st.it < 2 * opts.compact_rounds
    if not use:
        if xc is not None:
            xc.add_blocks(st.active, prob.y.shape[0] * B)
        st2, maxh = _active_pass(kind, prob, st, lam0, n_scale,
                                 opts.randomize, opts)
        return st2, maxh, cache

    if not reuse:
        if xc is not None:
            xc.add(C * prob.y.shape[0])
        big = torch.finfo(dt).max / 8
        pri = torch.where(st.beta != 0, torch.full_like(habs, big), habs)
        pri = torch.where(prob.valid, pri, torch.full_like(habs, -math.inf))
        # lax.top_k breaks ties toward the lower index; a stable descending
        # sort does the same, so the working set matches the JAX engine's
        order = torch.sort(pri.reshape(-1), descending=True, stable=True)[1]
        idx = torch.sort(order[:C])[0]
        cache = _ws_cache_from_idx(kind, prob, nc, opts, idx, True)
    bi, li = cache.idx // B, cache.idx % B
    sub_prob = BlockedProblem(
        Xb=cache.Xb, Xwb=cache.Xwb if kind == "wls" else cache.Xb, y=prob.y,
        q=None,
        adiag=prob.adiag[bi, li].reshape(nc, B),
        lamw=prob.lamw[bi, li].reshape(nc, B),
        valid=prob.valid[bi, li].reshape(nc, B),
        xwnorm=prob.xwnorm[bi, li].reshape(nc, B),
        Kb=cache.Kb)
    beta_ws = st.beta[bi, li].reshape(nc, B)
    # the outer gradient cache transfers coordinate-wise; a working-set
    # block's drift is bounded by its worst source block's drift
    sub_st = CDState(
        beta=beta_ws, r=st.r, rsqr=st.rsqr,
        active=torch.any(beta_ws != 0, dim=1), key=st.key, it=0, conv=True,
        done=False, c=st.c[bi, li].reshape(nc, B),
        drift=torch.amax(st.drift[bi].reshape(nc, B), dim=1))
    sub, _ = _solve_at_lambda_ws(kind, opts.replace(compact=False), sub_prob,
                                 lam0, sub_st, n_scale, None, xc=xc)
    beta2 = st.beta.clone()
    beta2[bi, li] = sub.beta.reshape(-1)
    dnorm = torch.sqrt(torch.sum((sub.r - st.r) ** 2))
    return (st._replace(beta=beta2, r=sub.r, rsqr=sub.rsqr,
                        active=torch.any(beta2 != 0, dim=1),
                        drift=st.drift + dnorm), 0.0, cache)


# ---------------------------------------------------------------------------
# Epoch loop and λ-continuation
# ---------------------------------------------------------------------------


class XCount:
    """The design elements a solve reads (``count_x``; the production
    X-traffic accounting of ``utils/profiling.py::solve_x_traffic``),
    counted by the JAX engine's rules: a full check reads ``n·B`` for each
    refreshed block, a dense active pass ``Σactive·n·B``, a compaction
    round ``C·n`` on a gather that is not a reuse plus its inner solve's
    own reads, and the quad kind is not counted.

    The counts are exact integers: a host ``int`` for what the host holds
    already (a check's ``n_need``, a round's reuse decision) and an int64
    device accumulator for the dense passes' ``Σactive``, read once by
    :meth:`total`, so counting adds no host read per epoch.  The JAX engine
    accumulates in float32 (block_cd.py:778, :879, :1261), exact only below
    2^24 elements: at small shapes the two agree exactly; at the bench
    shape (``n·B`` = 1.28M elements a block) a difference is the
    reference's rounding."""

    def __init__(self):
        self.host = 0
        self.dev = None

    def add(self, elements: int):
        self.host += elements

    def add_blocks(self, active, elements_per_block: int):
        """Add ``Σactive·elements_per_block`` on the device."""
        s = torch.sum(active) * elements_per_block
        self.dev = s if self.dev is None else self.dev + s

    def total(self) -> int:
        """The count so far (one host read when a dense pass ran)."""
        return self.host + (0 if self.dev is None else host.item(self.dev))


def _solve_at_lambda_ws(kind, opts: CDOptions, prob: BlockedProblem, lam0,
                        st: CDState, n_scale, cache, *, xc=None):
    """Alternate full checks and active (or compaction) passes until two
    consecutive converged passes, the confirming one full; a stall
    detector (sub-f64 dtypes only) stops a solve whose certified maxH has
    not improved for ``stall_patience`` full checks.  ``cache`` is the
    working-set cache carried across warm-started solves; returns
    ``(state, cache)``.  ``xc`` (an :class:`XCount` or ``None``) counts the
    design elements the solve reads."""
    dtype = st.beta.dtype
    # maxh and tol compare in the working dtype, as in the JAX engine
    tol = float(_np_dtype(dtype).type(opts.opt_tol))
    patience = (opts.stall_patience if dtype.itemsize < 8
                else np.iinfo(np.int32).max)
    nc = _compact_mode(kind, opts, prob, dtype)
    if not nc:
        cache = None
    elif cache is None:
        cache = _empty_ws_cache(kind, prob, nc, opts)
    st = st._replace(it=0, conv=True, done=False)
    best = math.inf
    stall = 0
    while not st.done and st.it < opts.max_iter:
        host.COUNTS["epochs"] += 1
        was_full = st.conv
        with host.span("cd.full_check" if was_full else
                       "cd.compact_pass" if nc else "cd.active_pass"):
            if was_full:
                s2, maxh = _full_check(kind, prob, st, lam0, n_scale,
                                       opts.opt_tol, opts, xc=xc)
            elif nc:
                s2, maxh, cache = _compact_pass(kind, prob, st, lam0,
                                                n_scale, opts, nc, cache,
                                                xc=xc)
            else:
                if xc is not None:
                    xc.add_blocks(st.active,
                                  prob.y.shape[0] * prob.lamw.shape[1])
                s2, maxh = _active_pass(kind, prob, st, lam0, n_scale,
                                        opts.randomize, opts)
            if isinstance(maxh, torch.Tensor):
                maxh = host.item(maxh)
        conv = maxh < tol
        if was_full:
            stall = 0 if maxh < best else stall + 1
            best = min(best, maxh)
        done = (was_full and conv) or stall >= patience
        st = s2._replace(it=st.it + 1, conv=conv, done=done)
    return st, cache


def _init_state(kind, prob: BlockedProblem, beta_b, key) -> CDState:
    """Recompute the residuals (``Ax`` for quad) from scratch, and ``‖r‖²``
    for sqrt; every cached gradient block starts invalid (drift sentinel
    1e30, finite so that ``inf·0`` never reaches the screening
    arithmetic)."""
    Xbeta = _blocks_matvec(prob.Xb, beta_b)
    r = Xbeta if kind == "quad" else prob.y - Xbeta
    nb = beta_b.shape[0]
    rsqr = (torch.dot(r, r) if kind == "sqrt"
            else torch.zeros((), dtype=r.dtype, device=r.device))
    return CDState(beta=beta_b, r=r, rsqr=rsqr,
                   active=torch.any(beta_b != 0, dim=1), key=key, it=0,
                   conv=True, done=False, c=torch.zeros_like(beta_b),
                   drift=torch.full((nb,), 1e30, dtype=beta_b.dtype,
                                    device=beta_b.device))


def _lambda_max(kind, prob: BlockedProblem, st: CDState, n_scale,
                kernels: bool):
    """Smallest λ0 zeroing the solution, ``max_k |∇_k f(0)|/λw_k``: the
    gradient is ``|X_k'r|/n`` for ls/wls, ``|X_k'r|/‖r‖`` for sqrt and
    ``|q_k|`` for quad."""
    c = _full_gradient_c(kind, prob, st.r, kernels)
    if kind in ("ls", "wls"):
        g = torch.abs(c) / n_scale
    elif kind == "sqrt":
        g = torch.abs(c) / torch.sqrt(torch.clamp_min(st.rsqr, 1e-30))
    else:
        g = torch.abs(c)
    t = torch.where(prob.valid, g / prob.lamw, torch.zeros_like(c))
    return torch.max(t)


@host.spanned("cd.solve")
def solve_blocked(kind: str, opts: CDOptions, prob: BlockedProblem, lam0,
                  beta0_b, key, count_x: bool = False):
    """Warm start from ``beta0`` or zero-start with log-spaced
    λ-continuation from λmax to ``lam0``.  Returns the final state, or
    with ``count_x=True`` ``(state, design elements read)``: the
    continuation's solves summed (not ``λmax``'s sweep, as in the JAX
    engine), one host read at the end of the solve (:class:`XCount`)."""
    dtype = beta0_b.dtype
    n_scale = 1.0 if kind == "quad" else float(prob.y.shape[0])
    if count_x and kind == "quad":
        raise ValueError("count_x unsupported for the quad kind")
    xc = XCount() if count_x else None
    if opts.warm_start:
        st = _init_state(kind, prob, beta0_b, key)
        st, _ = _solve_at_lambda_ws(kind, opts, prob, lam0, st, n_scale,
                                    None, xc=xc)
        return (st, xc.total()) if count_x else st

    st = _init_state(kind, prob, torch.zeros_like(beta0_b), key)
    npdt = _np_dtype(dtype)
    with host.span("cd.lambda_max"):
        lammax = npdt.type(host.item(_lambda_max(
            kind, prob, st, n_scale,
            kind != "quad" and use_kernels(opts, st.beta))))
    # log-spaced schedule, num_steps + 1 points inclusive, in dtype
    lams = np.exp(np.linspace(np.log(lammax), np.log(npdt.type(lam0)),
                              opts.num_steps + 1).astype(npdt)).tolist()
    nc = _compact_mode(kind, opts, prob, dtype)
    cache = _empty_ws_cache(kind, prob, nc, opts) if nc else None
    # the secant start is for the residual kinds (quad's r caches Ax)
    extrap = (nc and resolve_extrapolate(opts, True)
              and kind in ("ls", "wls", "sqrt"))
    beta_prev = st.beta
    lam_k = lam_km1 = lams[0]
    for lam in lams:
        beta_k = st.beta
        if extrap:
            st = _extrapolate_path_start(st, cache, beta_prev, lam_k,
                                         lam_km1, lam)
        st, cache = _solve_at_lambda_ws(kind, opts, prob, lam, st, n_scale,
                                        cache, xc=xc)
        beta_prev, lam_km1, lam_k = beta_k, lam_k, lam
    return (st, xc.total()) if count_x else st


def _path_point(kind, opts: CDOptions, prob: BlockedProblem, st: CDState,
                cache, lam, n_scale, secant, extrap: bool):
    """One point of a warm-started path along the penalty level (the λ
    scan of ``lasso_path``, its resumable form, the scaled Lasso's σ
    rounds): the secant start from ``secant = (beta_prev, lam_k,
    lam_km1)`` when ``extrap``, then the solve at ``lam`` carrying the
    state and the working-set cache; with ``warm_start=False``, zero β and
    the λ-continuation (visit orders from ``st.key``).  Returns ``(state,
    cache, secant)``, the secant's support points for the next point."""
    beta_k = st.beta
    if not opts.warm_start:
        st = solve_blocked(kind, opts, prob, lam, torch.zeros_like(st.beta),
                           st.key)
    else:
        if extrap:
            st = _extrapolate_path_start(st, cache, *secant, lam)
        st, cache = _solve_at_lambda_ws(kind, opts, prob, lam, st, n_scale,
                                        cache)
    return st, cache, (beta_k, lam, secant[1])


# ---------------------------------------------------------------------------
# Public entry point
# ---------------------------------------------------------------------------


def _unblock(beta_b, p):
    return beta_b.reshape(-1)[:p]


def _to_blocked_beta(beta0, B):
    P = -(-beta0.shape[0] // B) * B
    return _pad_to_blocks(beta0, B).reshape(P // B, B)


def coordinate_descent(beta0, loss, penalty, options: CDOptions = CDOptions(),
                       *, seed: int = 0, key=None, device=None):
    """Minimize ``f(β) + Σ_j λ0 λw_j |β_j|``; returns ``(beta, residuals)``,
    ``residuals`` being ``y − Xβ`` for the regression losses and ``Aβ`` for
    ``QuadraticLoss``.  ``penalty`` is a ``ProxL1`` (optionally weighted),
    ``ProxZero``, or a ``ProxL1Group`` (routed to the group engine,
    ``ops/group_cd.py``).  ``key`` is an optional ``torch.Generator`` for
    the randomized visit orders (default: one seeded with ``seed``).  Runs
    on ``device`` (``None``: the GPU; ``"cpu"`` for the plain path on the
    CPU), where the inputs are moved."""
    if not isinstance(loss, (LeastSquaresLoss, WeightedLSLoss, SqrtLassoLoss,
                             QuadraticLoss)):
        raise NotImplementedError(
            f"{type(loss).__name__} is not a loss of this package")
    if isinstance(penalty, ProxL1Group):
        from .group_cd import group_coordinate_descent

        return group_coordinate_descent(beta0, loss, penalty, options,
                                        seed=seed, key=key, device=device)
    if not isinstance(penalty, (ProxL1, ProxZero)):
        raise NotImplementedError(
            f"{type(penalty).__name__} is not a penalty of this package "
            "(ProxL1, ProxZero and ProxL1Group)")
    p = beta0.shape[0]
    if num_coordinates(loss) != p:
        raise ValueError("dimension mismatch between beta0 and loss")
    dev = target_device(device)
    quad = isinstance(loss, QuadraticLoss)
    lead = on_device(loss.b if quad else loss.X, dev)
    dtype = lead.dtype
    lam0, lamw = as_l1(penalty, p, dtype, dev)
    if key is None:
        key = torch.Generator().manual_seed(seed)
    beta0 = on_device(beta0, dev, dtype)
    if isinstance(penalty, ProxZero):
        # the unpenalized solve never runs the λ-continuation: from beta0
        # when warm-started, from zero otherwise, one solve either way
        if not options.warm_start:
            beta0 = torch.zeros_like(beta0)
        options = options.replace(warm_start=True)
    with full_f32_matmuls():
        if quad:
            prob = build_blocked("quad", options, lamw,
                                 A=on_device(loss.A, dev, dtype), q=lead)
        else:
            w = (on_device(loss.w, dev, dtype)
                 if isinstance(loss, WeightedLSLoss) else None)
            if w is not None and tuple(w.shape) != (lead.shape[0],):
                raise ValueError("row weight vector has wrong length")
            prob = build_blocked(loss.kind, options, lamw, X=lead,
                                 y=on_device(loss.y, dev, dtype), w=w)
        st = solve_blocked(loss.kind, options, prob, lam0,
                           _to_blocked_beta(beta0, options.block_size), key)
    return _unblock(st.beta, p), st.r
