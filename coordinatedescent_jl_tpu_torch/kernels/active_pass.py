"""K1: the fused active pass (``csrc/active_pass.cu``) and its plain twin.

Replaces ``coordinatedescent_jl_tpu/ops/pallas_block.py:fused_active_pass``
(the chunked kernel ``_make_chunked_kernel`` that runs at n = 10K, and the
resident kernel ``_make_resident_kernel`` for small n: the CUDA kernels'
row-chunk loop covers both).  One active-set block-CD pass over the blocks
in ``_prefetch_order``: per active block, ``K = Xw_b'X_b`` (or the cached
Gram), ``c = Xw_b'r``, a block solve (``_block_ista``: FISTA with a
Gershgorin step, zero-snap and dead-column guard; or ``_block_scan``: the
exact Gauss-Seidel scan through the Gram recursion), then
``r -= X_b·Δβ_b``.

Design on the H100 (see the CUDA source for the details): the TPU kernel
relies on its grid running in order on one core; here the host reads
``n_active`` once per pass and one C call launches, per visit, a
row-chunk partial kernel (plus a partial-Gram kernel when no Gram is
cached), a one-CTA solve that adds the partials in a fixed order, and a
row-parallel residual update.  It is bounded by the device-memory read of
each visited block and by the four launches per visit.

``LAUNCHES`` (float32) and ``LAUNCHES_F64`` (float64, the polish's inner
solve) count wrapper calls that launched the kernels; the plain twin
never counts.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from ..utils import host

LAUNCHES = 0
LAUNCHES_F64 = 0
_ROW_CHUNK = 256   # rows per partial-sum CTA
_MAX_B = 128       # widest block the kernels take (K fits shared memory)


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
                      iters: int = 16):
    """One fused active-set pass; returns ``(beta_b, r, maxh, rsqr)``.

    CUDA tensors launch the kernels (or raise); CPU tensors run the plain
    twin :func:`fused_active_pass_plain`."""
    if rsqr is None:
        rsqr = torch.zeros((), dtype=beta_b.dtype, device=beta_b.device)
    if not beta_b.is_cuda:
        return fused_active_pass_plain(prob, beta_b, r, active, lam0,
                                       n_scale, border, corder, kind=kind,
                                       rsqr=rsqr, inner=inner, iters=iters)
    return _fused_active_pass_cuda(prob, beta_b, r, active, lam0, n_scale,
                                   border, corder, kind, rsqr, inner, iters)


def _fused_active_pass_cuda(prob, beta_b, r, active, lam0, n_scale, border,
                            corder, kind, rsqr, inner, iters):
    global LAUNCHES, LAUNCHES_F64
    req = _build.require
    nb, B = prob.lamw.shape
    n = r.shape[0]
    dt = beta_b.dtype
    req(kind == "ls", f"active-pass kernel: kind {kind!r} is not ported")
    req(inner in ("ista", "exact"), f"active-pass kernel: inner {inner!r}")
    req(dt in (torch.float32, torch.float64),
        f"active-pass kernel: dtype {dt} (float32/float64 only)")
    req(1 <= B <= _MAX_B, f"active-pass kernel: block width {B} > {_MAX_B}")
    Kb = prob.Kb
    for name, t, shape in (("Xb", prob.Xb, (nb, n, B)),
                           ("lamw", prob.lamw, (nb, B)),
                           ("beta", beta_b, (nb, B)), ("r", r, (n,)),
                           ("Kb", Kb, (nb, B, B))):
        if t is None:
            continue
        req(t.is_cuda and t.device == beta_b.device and t.dtype == dt,
            f"active-pass kernel: {name} must be {dt} on {beta_b.device}")
        req(tuple(t.shape) == shape and t.is_contiguous(),
            f"active-pass kernel: {name} must be contiguous {shape}, got "
            f"{tuple(t.shape)}")
    req(prob.Xwb is None or prob.Xwb.data_ptr() == prob.Xb.data_ptr(),
        "active-pass kernel: least squares needs Xwb to be Xb")
    for name, t, shape in (("active", active, (nb,)),
                           ("border", border, (nb,)),
                           ("corder", corder, (B,))):
        req(t.device == beta_b.device and tuple(t.shape) == shape,
            f"active-pass kernel: {name} must be {shape} on {beta_b.device}")

    order, n_active = _prefetch_order(active, border)
    na = host.item(n_active)
    beta2 = beta_b.clone()
    r2 = r.clone()
    maxh = torch.zeros((1,), dtype=dt, device=r.device)
    if na == 0:
        return beta2, r2, maxh[0], rsqr
    nr = -(-n // _ROW_CHUNK)
    gram = Kb is not None
    part_c = torch.empty((nr, B), dtype=dt, device=r.device)
    part_k = (None if gram
              else torch.empty((nr, B, B), dtype=dt, device=r.device))
    dvec = torch.empty((B,), dtype=dt, device=r.device)
    corder = corder.to(torch.int32).contiguous()
    lib = _build.library()
    fn = lib.cdt_active_pass_f32 if dt == torch.float32 else \
        lib.cdt_active_pass_f64
    P = _build.ptr
    err = fn(P(prob.Xb), P(Kb), P(prob.lamw), P(order), P(corder),
             P(beta2), P(r2), P(maxh), P(part_c), P(part_k), P(dvec),
             na, n, B, _ROW_CHUNK, int(inner == "ista"), int(iters),
             int(gram), float(lam0), float(n_scale), _build.stream())
    _build.check(err, "active_pass")
    if dt == torch.float64:
        LAUNCHES_F64 += 1
    else:
        LAUNCHES += 1
    return beta2, r2, maxh[0], rsqr


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


def _block_scan(corder, K, c, beta0, lamw, thr_scale):
    """Exact sequential CD over one block in ``corder`` (host list) via
    ``c ← c − K[k, :]·h``.  Returns ``(beta1, maxh)``."""
    beta = beta0.clone()
    adiag = torch.diagonal(K)
    mh = torch.zeros((), dtype=c.dtype, device=c.device)
    for k in corder:
        a = adiag[k]
        bk = beta[k].clone()
        safe = a > 0
        asafe = torch.where(safe, a, torch.ones_like(a))
        val = torch.where(safe, _soft(bk + c[k] / asafe,
                                      thr_scale * lamw[k] / asafe), bk)
        h = val - bk
        c = c - K[k, :] * h
        beta[k] = bk + h
        mh = torch.maximum(mh, torch.abs(h))
    return beta, mh


def fused_active_pass_plain(prob, beta_b, r, active, lam0, n_scale, border,
                            corder, *, kind: str = "ls", rsqr=None,
                            inner: str = "exact", iters: int = 16):
    """Plain PyTorch twin of the fused active pass (same visit order, same
    inner solves, same outputs)."""
    if kind != "ls":
        raise NotImplementedError(f"kind {kind!r} is not ported yet")
    if rsqr is None:
        rsqr = torch.zeros((), dtype=beta_b.dtype, device=beta_b.device)
    nb, B = prob.lamw.shape
    order, n_active = _prefetch_order(active, border)
    flat = host.tolist(torch.cat([n_active.reshape(1), order,
                                  corder.to(torch.int32)]))
    na, order_h, corder_h = flat[0], flat[1:1 + nb], flat[1 + nb:]
    npdt = np.dtype(str(beta_b.dtype).replace("torch.", "")).type
    thr_scale = float(npdt(n_scale) * npdt(lam0))
    beta = beta_b.clone()
    maxh = torch.zeros((), dtype=beta.dtype, device=beta.device)
    for b in order_h[:na]:
        X = prob.Xb[b]
        K = prob.Kb[b] if prob.Kb is not None else prob.Xwb[b].T @ X
        c = r @ prob.Xwb[b]
        beta0 = beta[b].clone()
        if inner == "ista":
            beta1, mh = _block_ista(K, c, beta0, prob.lamw[b], thr_scale,
                                    iters)
        else:
            beta1, mh = _block_scan(corder_h, K, c, beta0, prob.lamw[b],
                                    thr_scale)
        r = r - X @ (beta1 - beta0)
        beta[b] = beta1
        maxh = torch.maximum(maxh, mh)
    return beta, r, maxh, rsqr
