"""K1: the fused active pass (``csrc/active_pass.cu``) and its plain twin.

Replaces ``coordinatedescent_jl_tpu/ops/pallas_block.py:fused_active_pass``
(the chunked kernel ``_make_chunked_kernel`` that runs at n = 10K, and the
resident kernel ``_make_resident_kernel`` for small n: the CUDA kernels'
row-chunk loop covers both), for the three kinds it takes: ``ls``, ``wls``
(a second, row-weighted design ``Xwb`` for the Gram and the gradient; the
residual update reads the unweighted ``Xb``) and ``sqrt`` (the running
``‖r‖²`` goes in and comes back).  One active-set block-CD pass over the
blocks in ``_prefetch_order``: per active block, ``K = Xw_b'X_b`` (or the
cached Gram), ``c = Xw_b'r``, a block solve (``_block_ista``: FISTA with a
Gershgorin step, zero-snap and dead-column guard, for sqrt on the MM
majorizer's threshold ``λ0·‖r‖`` with ``‖r‖²`` rebuilt from the new
residual after every visit; or ``_block_scan``: the exact Gauss-Seidel
scan through the Gram recursion, for sqrt with the three-branch
minimizer and ``‖r‖²`` carried through the coordinates), then
``r -= X_b·Δβ_b``.

Design on the H100 (see the CUDA source for the details): the TPU kernel
relies on its grid running in order on one core; here one launch per pass
runs G CTAs that each own a slice of the rows of r for the whole pass,
find the visit order on the device (no host read of ``n_active``), meet
at a barrier per visit and solve each block redundantly.
:func:`plan_active_pass` sizes the grid and the shared memory and picks
the route: where at most 16 CTAs of at most 64 rows keep every row of r
and of X_b in shared memory (n up to 1,024 at B = 128 in f32, the
resident kernel's regime) the CTAs are one thread-block cluster, launched
with no co-residency query and no scratch, their partial sums read out of
each other's shared memory, the Gram multicast to all of them by bulk
copies; else a cooperative launch of up to one CTA an SM exchanges them
through global scratch.  The two routes give the same bits at the same G
and rows.  Per visit it is bounded by the barrier's latency, the Gram's
read from L2 and the solve's chain of steps.

``LAUNCHES_KIND[kind][dtype is float64]`` counts the wrapper calls that
launched the kernel (float64: the polishes' inner solves), and
``LAUNCHES_SHAPE[(kind, dtype is float64, n, cluster route)]`` the same
launches by rows and route.  The plain twin never counts.

While a profiler runs, each launch sits in the mark ``cdt#k1 n= B= iters=
gram= x_item=`` (``utils/host.py``): ``iters`` the FISTA steps a block (0
for the exact scan), ``gram`` whether the Grams are cached.  The mark
keeps the ``active`` mask, and the blocks the pass visits (the active
ones) are counted after the entry point returns, under ``k1`` in
``cdt#counted``: no read during the solve.
"""

from __future__ import annotations

import collections
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from ..ops.prox import sqrt_candidate
from ..utils import host

LAUNCHES_KIND = {"ls": [0, 0], "wls": [0, 0], "sqrt": [0, 0]}
LAUNCHES_SHAPE = collections.Counter()
_KINDS = {"ls": 0, "wls": 1, "sqrt": 2}   # csrc/active_pass.cu's KIND_*
_MAX_B = 128       # widest block the kernel takes (K fits shared memory)
# the kernel's shape (csrc/active_pass.cu): threads per CTA, B-long vectors
# in shared memory, and the fewest rows of r a CTA should own (below it a
# small n takes fewer CTAs, so fewer meet at each grid barrier)
_AP_THREADS = 512
_AP_NVEC = 9
_AP_MIN_ROWS = 32
_MAX_CLUSTER = _build.MAX_CLUSTER   # CTAs of the largest cluster
# the most rows a CTA of the cluster route owns: at 125 and 256 rows (n =
# 2,000 and 4,096, f32, B = 128) its 16 CTAs measured 2 % and 15 % slower
# than the cooperative route's CTA an SM (PERF.md §6)
_CLUSTER_MAX_ROWS = 64
SMEM_OPTIN_H100 = 232_448   # shared memory one CTA may opt in to (H100)


class ActivePlan(NamedTuple):
    grid: int      # CTAs (co-resident, or one cluster)
    rows: int      # rows of r (and of each X_b) a CTA owns
    keep_x: bool   # the CTA keeps its rows of X_b in shared memory
    keep_r: bool   # ... and its rows of r (else they live in r_out)
    smem: int      # dynamic shared memory per CTA, bytes
    cluster: bool = False   # the cluster route (else the cooperative one)


def _smem(B: int, itemsize: int, grid: int, rows: int, keep_x: bool,
          keep_r: bool, cluster: bool, gram: bool) -> int:
    """Bytes of ``csrc/active_pass.cu::ap_layout``: a 16-byte header, the
    row-group sums (16 bytes a thread), on the cluster route the partial
    c's of two parities, the partial ‖r‖² and the Gram copies' mbarrier
    (32 bytes) and without a Gram
    the CTA's slice of the summed Gram (``ceil(B² / grid)`` entries, in
    16-byte steps), the kept rows of X_b, the Gram at row stride
    ``B + 128 / itemsize``, nine B-long vectors, 32 reduction slots and
    the kept rows of r."""
    v = 16 // itemsize
    ks = 0 if gram or not cluster else -(-(-(-B * B // grid)) // v) * v
    elems = (_AP_THREADS * v + (2 * B + 2 * v if cluster else 0) + ks
             + rows * B * int(keep_x) + B * (B + 128 // itemsize)
             + _AP_NVEC * B + 32 + rows * int(keep_r))
    return 16 + itemsize * elems


def _rows(n: int, most: int):
    """(CTAs, rows a CTA) for ``n`` rows on at most ``most`` CTAs of
    ``_AP_MIN_ROWS`` rows or more, no CTA without rows."""
    grid = max(1, min(most, -(-n // _AP_MIN_ROWS)))
    rows = -(-n // grid)
    return -(-n // rows), rows


@functools.lru_cache(maxsize=64)
def plan_active_pass(n: int, B: int, itemsize: int, sms: int,
                     smem_limit: int = SMEM_OPTIN_H100,
                     gram: bool = True,
                     max_cluster: int = _MAX_CLUSTER) -> ActivePlan:
    """K1's launch plan, for a pass with (``gram``) or without a cached
    Gram.  The cluster route where at most ``max_cluster`` (the largest
    cluster the card holds, :func:`card_plan`; at most ``_MAX_CLUSTER``)
    CTAs of ``_AP_MIN_ROWS`` to ``_CLUSTER_MAX_ROWS`` rows keep every row
    of r and of X_b in shared memory under ``smem_limit``.  Else the
    cooperative route: one
    CTA per SM (the Gram alone takes 64-128 KB of shared memory), fewer
    when n gives a CTA under ``_AP_MIN_ROWS`` rows; each keeps its rows of
    r, then its rows of X_b, in shared memory while they fit."""
    base = _smem(B, itemsize, 1, 0, False, False, False, True)
    if base > smem_limit:
        raise ValueError(f"active-pass kernel: block width {B} needs "
                         f"{base} bytes of shared memory > {smem_limit}")
    grid, rows = _rows(n, min(_MAX_CLUSTER, max_cluster))
    smem = _smem(B, itemsize, grid, rows, True, True, True, gram)
    if rows <= _CLUSTER_MAX_ROWS and smem <= smem_limit:
        return ActivePlan(grid, rows, True, True, smem, True)
    grid, rows = _rows(n, sms)
    keep_r = base + itemsize * rows <= smem_limit
    keep_x = keep_r and base + itemsize * rows * (B + 1) <= smem_limit
    return ActivePlan(grid, rows, keep_x, keep_r,
                      _smem(B, itemsize, grid, rows, keep_x, keep_r, False,
                            gram))


@functools.lru_cache(maxsize=64)
def card_plan(n: int, B: int, dtype, dev, gram: bool = True,
              kind: str = "ls") -> ActivePlan:
    """The plan a launch on ``dev`` takes: :func:`plan_active_pass` at
    the card's SMs, its shared memory a CTA may opt in to, and the largest
    cluster of the kind's cluster-route kernel of which it holds one at
    that shared memory (``cudaOccupancyMaxActiveClusters``, once per
    device: every plan's CTA takes at most that much)."""
    dt = "f32" if dtype == torch.float32 else "f64"
    optin = _build.smem_optin(dev)
    return plan_active_pass(
        n, B, dtype.itemsize, _build.sm_count(dev), optin, gram,
        _build.largest_cluster(f"cdt_active_pass_clusters_{dt}", dev.index,
                               _KINDS[kind], optin))


def on_route(plan: ActivePlan, cluster: bool, B: int, itemsize: int,
             gram: bool = True) -> ActivePlan:
    """``plan``'s CTAs and rows on the other route (or the same), for the
    tests and ``chip_smoke.py``'s route-against-route check."""
    return plan._replace(cluster=cluster, smem=_smem(
        B, itemsize, plan.grid, plan.rows, plan.keep_x, plan.keep_r,
        cluster, gram))


def _prefetch_order(active, border):
    """Visit order: the active blocks first, in ``border`` order (stable
    partition), then the skipped tail clamped to the last active block.
    Returns ``(order int32, n_active 0-d int32)``."""
    nb = border.shape[0]
    keep = active[border]
    idx = torch.argsort((~keep).to(torch.int32), stable=True)
    order = border[idx].to(torch.int32)
    n_active = torch.sum(keep).to(torch.int32)
    # a gather, not order[n_active - 1]: indexing with a device scalar
    # would read it to the host
    last = order.gather(0, torch.clamp_min(n_active - 1, 0).reshape(1).long())
    tpos = torch.arange(nb, dtype=torch.int32, device=border.device)
    return torch.where(tpos < n_active, order, last), n_active


def fused_active_pass(prob, beta_b, r, active, lam0, n_scale, border, corder,
                      *, kind: str = "ls", rsqr=None, inner: str = "exact",
                      iters: int = 16, plan: ActivePlan | None = None):
    """One fused active-set pass; returns ``(beta_b, r, maxh, rsqr)``.

    CUDA tensors launch the kernels (or raise); CPU tensors run the plain
    twin :func:`fused_active_pass_plain`.  ``plan`` (default
    :func:`plan_active_pass`'s) lets a test or ``chip_smoke.py`` launch
    another route (:func:`on_route`)."""
    if rsqr is None:
        rsqr = torch.zeros((), dtype=beta_b.dtype, device=beta_b.device)
    if not beta_b.is_cuda:
        return fused_active_pass_plain(prob, beta_b, r, active, lam0,
                                       n_scale, border, corder, kind=kind,
                                       rsqr=rsqr, inner=inner, iters=iters)
    return _fused_active_pass_cuda(prob, beta_b, r, active, lam0, n_scale,
                                   border, corder, kind, rsqr, inner, iters,
                                   plan)


def _fused_active_pass_cuda(prob, beta_b, r, active, lam0, n_scale, border,
                            corder, kind, rsqr, inner, iters, plan):
    # the checks run on every pass (hundreds per solve): plain comparisons,
    # messages built only on failure
    nb, B = prob.lamw.shape
    n = r.shape[0]
    dt = beta_b.dtype
    dev = beta_b.device
    Kb, Xb = prob.Kb, prob.Xb
    Xwb = Xb if prob.Xwb is None else prob.Xwb
    if not (kind in _KINDS and inner in ("ista", "exact")
            and dt in (torch.float32, torch.float64) and 1 <= B <= _MAX_B):
        raise ValueError(
            f"active-pass kernel: kind {kind!r}, inner {inner!r}, dtype "
            f"{dt}, block width {B} (ls, wls or sqrt; ista or exact; "
            f"float32 or float64; at most {_MAX_B})")
    for name, t, shape, dts in (
            ("Xb", Xb, (nb, n, B), (dt,)),
            ("Xwb", None if Xwb is Xb else Xwb, (nb, n, B), (dt,)),
            ("lamw", prob.lamw, (nb, B), (dt,)),
            ("beta", beta_b, (nb, B), (dt,)), ("r", r, (n,), (dt,)),
            ("rsqr", rsqr, (), (dt,)), ("Kb", Kb, (nb, B, B), (dt,)),
            ("active", active, (nb,), (torch.bool,)),
            ("border", border, (nb,), (torch.int64, torch.int32)),
            ("corder", corder, (B,), (torch.int64, torch.int32))):
        if t is not None and not (t.device == dev and t.dtype in dts
                                  and t.shape == shape and t.is_contiguous()):
            raise ValueError(f"active-pass kernel: {name} must be contiguous "
                             f"{shape} {dts} on {dev}")
    if kind != "wls" and Xwb.data_ptr() != Xb.data_ptr():
        raise ValueError(f"active-pass kernel: kind {kind!r} has one design: "
                         "Xwb must be Xb")
    # int64 orders (torch.arange / randperm) pass through without a copy
    if border.dtype != torch.int64:
        border = border.to(torch.int64)
    if corder.dtype != torch.int64:
        corder = corder.to(torch.int64)
    gram = Kb is not None
    if plan is None:
        plan = card_plan(n, B, dt, dev, gram, kind)
    # outputs: beta, r, maxh and rsqr in one allocation
    out = torch.empty((nb * B + n + 2,), dtype=dt, device=dev)
    op, w = out.data_ptr(), dt.itemsize
    if plan.cluster:
        # the partials stay in the cluster's shared memory: no scratch
        part = [None] * 4
    else:
        # scratch: the partial c's (2 parities x G x B) and the partial
        # sums of r^2 (2 parities x G, the sqrt kind's), and without a Gram
        # the partial Grams (G x B x B) and their sum (B x B)
        nc = 2 * plan.grid * B
        nrs = 2 * plan.grid
        nk = 0 if gram else plan.grid * B * B
        scratch = torch.empty((nc + nrs + (0 if gram else nk + B * B),),
                              dtype=dt, device=dev)
        sp = scratch.data_ptr()
        part = [sp, sp + nc * w, None if gram else sp + (nc + nrs) * w,
                None if gram else sp + (nc + nrs + nk) * w]
    lib = _build.library()
    fn = lib.cdt_active_pass_f32 if dt == torch.float32 else \
        lib.cdt_active_pass_f64
    with host.mark("k1", later=active, n=n, B=B,
                   iters=iters if inner == "ista" else 0, gram=int(gram),
                   x_item=w):
        err = fn(Xb.data_ptr(), Xwb.data_ptr(),
                 None if Kb is None else Kb.data_ptr(),
                 prob.lamw.data_ptr(), border.data_ptr(), active.data_ptr(),
                 corder.data_ptr(), beta_b.data_ptr(), r.data_ptr(),
                 rsqr.data_ptr(), op, op + nb * B * w, op + (nb * B + n) * w,
                 op + (nb * B + n + 1) * w, *part,
                 nb, n, B, plan.grid, plan.rows, int(plan.keep_x),
                 int(plan.keep_r), plan.smem, int(plan.cluster),
                 _KINDS[kind], int(inner == "ista"), int(iters),
                 float(lam0), float(n_scale), _build.stream(dev))
    _build.check(err, "active_pass")
    LAUNCHES_KIND[kind][dt == torch.float64] += 1
    LAUNCHES_SHAPE[kind, dt == torch.float64, n, plan.cluster] += 1
    if _build.NAN_CHECK:
        _build.check_nans("active_pass",
                          out[:nb * B + n + 1 + (kind == "sqrt")])
    # three view ops for the four outputs (each costs the host as much as
    # the C call); only the sqrt kind moves ||r||^2, and only its kernel
    # writes it
    beta2, r2, tail = out.split_with_sizes((nb * B, n, 2))
    maxh, rsqr2 = tail.unbind()
    return beta2.view(nb, B), r2, maxh, rsqr2 if kind == "sqrt" else rsqr


# ---------------------------------------------------------------------------
# Plain twin
# ---------------------------------------------------------------------------


def _block_ista(K, c, beta0, lamw, thr_scale, iters: int):
    """``iters`` FISTA steps on one block's LS + L1 subproblem with the
    Gershgorin step ``L = max column abs-sum``, then the zero-snap and the
    dead-column guard.  The momentum sequence is computed in the working
    dtype, as the kernel does.  Returns ``(d, maxh)``."""
    npdt = np.dtype(str(c.dtype).replace("torch.", "")).type
    L = torch.clamp_min(torch.max(torch.sum(torch.abs(K), dim=0)), 1e-30)
    thr = thr_scale * lamw / L
    q0 = c + beta0 @ K
    d = d_prev = beta0
    t = npdt(1)
    for _ in range(iters):
        t_next = npdt(0.5) * (npdt(1) + np.sqrt(npdt(1) + npdt(4) * t * t))
        coef = float((t - npdt(1)) / t_next)
        yv = d + coef * (d - d_prev)
        d_prev, d = d, _soft(yv + (q0 - yv @ K) / L, thr)
        t = t_next
    q = q0 - d @ K
    adiag = torch.diagonal(K)
    d = torch.where(torch.abs(adiag * d + q) <= thr_scale * lamw,
                    torch.zeros_like(d), d)
    d = torch.where(adiag > 0, d, beta0)
    return d, torch.max(torch.abs(d - beta0))


def _soft(x, t):
    return torch.sign(x) * torch.clamp_min(torch.abs(x) - t, 0.0)


def _block_scan(corder, K, c, beta0, lamw, thr_scale, kind="ls", lam0=0.0,
                rsqr=None):
    """Exact sequential CD over one block in ``corder`` (host list) via
    ``c ← c − K[k, :]·h``; for ``kind="sqrt"`` the running ``‖r‖²`` goes
    through the three-branch minimizer.  Returns ``(beta1, maxh, rsqr1)``."""
    beta = beta0.clone()
    adiag = torch.diagonal(K)
    mh = torch.zeros((), dtype=c.dtype, device=c.device)
    for k in corder:
        a = adiag[k]
        bk = beta[k].clone()
        if kind == "sqrt":
            val, sv, rsb = sqrt_candidate(bk, c[k], a, rsqr, lam0, lamw[k])
            rsqr = torch.clamp_min(rsb - 2.0 * val * sv + val * val * a, 0.0)
        else:
            safe = a > 0
            asafe = torch.where(safe, a, torch.ones_like(a))
            val = torch.where(safe, _soft(bk + c[k] / asafe,
                                          thr_scale * lamw[k] / asafe), bk)
        h = val - bk
        c = c - K[k, :] * h
        beta[k] = bk + h
        mh = torch.maximum(mh, torch.abs(h))
    return beta, mh, rsqr


def fused_active_pass_plain(prob, beta_b, r, active, lam0, n_scale, border,
                            corder, *, kind: str = "ls", rsqr=None,
                            inner: str = "exact", iters: int = 16):
    """Plain PyTorch twin of the fused active pass (same visit order, same
    inner solves, same thresholds and ``rsqr`` rules, same outputs), for the
    kinds ``ls``, ``wls`` and ``sqrt``."""
    if kind not in _KINDS:
        raise ValueError(f"active pass: kind {kind!r} (ls, wls or sqrt)")
    if rsqr is None:
        rsqr = torch.zeros((), dtype=beta_b.dtype, device=beta_b.device)
    nb, B = prob.lamw.shape
    Xwb = prob.Xb if prob.Xwb is None else prob.Xwb
    order, n_active = _prefetch_order(active, border)
    flat = host.tolist(torch.cat([n_active.reshape(1), order,
                                  corder.to(torch.int32)]))
    na, order_h, corder_h = flat[0], flat[1:1 + nb], flat[1 + nb:]
    npdt = np.dtype(str(beta_b.dtype).replace("torch.", "")).type
    thr_scale = float(npdt(n_scale) * npdt(lam0))
    lam0_t = float(npdt(lam0))
    beta = beta_b.clone()
    maxh = torch.zeros((), dtype=beta.dtype, device=beta.device)
    for b in order_h[:na]:
        X = prob.Xb[b]
        K = prob.Kb[b] if prob.Kb is not None else Xwb[b].T @ X
        c = r @ Xwb[b]
        beta0 = beta[b].clone()
        if inner == "ista":
            # sqrt: the MM majorizer's threshold λ0·‖r‖ at this visit's start
            ts = (lam0_t * torch.sqrt(torch.clamp_min(rsqr, 1e-30))
                  if kind == "sqrt" else thr_scale)
            beta1, mh = _block_ista(K, c, beta0, prob.lamw[b], ts, iters)
        else:
            beta1, mh, rsqr = _block_scan(corder_h, K, c, beta0, prob.lamw[b],
                                          thr_scale, kind, lam0_t, rsqr)
        r = r - X @ (beta1 - beta0)
        if kind == "sqrt" and inner == "ista":
            rsqr = torch.sum(r * r)     # rebuilt for the next visit
        beta[b] = beta1
        maxh = torch.maximum(maxh, mh)
    return beta, r, maxh, rsqr
