"""The varying-coefficient grid's refine round (``csrc/vc_round.cu``).

Replaces no Pallas kernel: the JAX package's batched grid and batched
LOO-CV run their rounds as XLA programs.  Their plain twin,
``models/varying_coefficient.py::_VcBatchOps.round_plain``, runs a round as
small eager launches: ``block_iters`` preconditioned FISTA steps of two
GEMMs against the shared X and ~20 elementwise operations each, the fresh
residual, the noise-floor-masked KKT certificate, its per-lane max and the
stall-escape update (~430 device operations a round at n = 500, p = 50,
degree 1 and 16 steps).  Here the whole round is one launch: one CTA a
lane, the lane's step vectors in shared memory for the round, and X with
the lane's rows beside them where they fit (route 0), else read from L2
(route 1); the route is chosen from the shapes and the card's shared
memory.  The arithmetic is the plain round's, operation for operation,
with the two products' sums in another order; a certified lane's
coefficients are the twin's bit for bit.  It is bounded by the chain of
dependent FISTA steps, not by bytes or flops; the host's dispatch, which
bounded the plain round, is off that chain.

``LAUNCHES`` counts the wrapper calls that launched the kernel (one a
refine round on the card).
"""

from __future__ import annotations

import torch

from . import _build
from ..utils import host

LAUNCHES = 0
_THREADS = 512     # csrc/vc_round.cu VC_THREADS


def groups(n: int, p: int) -> int:
    """Row groups of the transposed product (``csrc/vc_round.cu::
    vc_groups``): as many groups of ``p`` column threads as 512 threads
    hold, at most ``n``; one from 512 columns on."""
    return 1 if p >= _THREADS else min(_THREADS // p, n)


def smem_bytes(n: int, p: int, q1: int, itemsize: int, route: int) -> int:
    """Dynamic shared memory of one CTA (``csrc/vc_round.cu::vc_layout``,
    which refuses any other count): on route 0 X at an odd row stride and
    the lane's weights, response, powers and weighted residual; on both
    routes five step vectors of ``p·q1``, the transposed product's
    partials and 32 reduction slots, each array rounded up to 16 bytes."""
    V = 16 // itemsize

    def up(x):
        return -(-x // V) * V

    ep = p * q1
    rows = n if route == 0 else 0
    return itemsize * (up(rows * (p | 1)) + 2 * up(rows) + 2 * up(rows * q1)
                       + 5 * up(ep) + up(groups(n, p) * ep) + 32)


def pick_route(n: int, p: int, q1: int, itemsize: int, optin: int) -> int:
    """Route 0 where X and the lane's rows fit in ``optin`` bytes of shared
    memory beside the step vectors, else route 1."""
    return 0 if smem_bytes(n, p, q1, itemsize, 0) <= optin else 1


def require_inputs(X, y, w, dpow, sc, Lt, adiag, xwnorm, thrw, B, cert,
                   best, stall, esc):
    """The shapes, dtypes and layout the kernel takes (raises
    ``ValueError`` on any other): float32 or float64 throughout, ``X (n,
    p)``, ``y (n,)``, ``w (k, n)``, ``dpow (k, n, q1)``, ``sc``, ``adiag``,
    ``xwnorm``, ``thrw`` and ``B`` ``(k, p·q1)``, ``Lt`` and ``best``
    ``(k,)``, ``cert`` and ``esc`` ``(k,)`` bool, ``stall`` ``(k,)``
    int32, all contiguous and on one device."""
    req = _build.require
    req(B.dim() == 2 and X.dim() == 2 and dpow.dim() == 3,
        "vc-round kernel: B must be (k, p*q1), X (n, p) and dpow (k, n, q1)")
    dt = B.dtype
    req(dt in (torch.float32, torch.float64),
        "vc-round kernel: dtype {} (float32/float64 only)", dt)
    (k, ep), (n, p), q1 = B.shape, X.shape, dpow.shape[2]
    req(q1 >= 1 and ep == p * q1,
        "vc-round kernel: B has {} columns, not p * q1 = {} * {}", ep, p, q1)
    for name, t, shape in (("X", X, (n, p)), ("y", y, (n,)),
                           ("w", w, (k, n)), ("dpow", dpow, (k, n, q1)),
                           ("sc", sc, (k, ep)), ("Lt", Lt, (k,)),
                           ("adiag", adiag, (k, ep)),
                           ("xwnorm", xwnorm, (k, ep)),
                           ("thrw", thrw, (k, ep)), ("B", B, (k, ep)),
                           ("best", best, (k,))):
        req(t.device == B.device and t.dtype == dt,
            "vc-round kernel: {} must be {} on {}", name, dt, B.device)
        req(tuple(t.shape) == shape and t.is_contiguous(),
            "vc-round kernel: {} must be contiguous {}", name, shape)
    for name, t, tdt in (("cert", cert, torch.bool),
                         ("stall", stall, torch.int32),
                         ("esc", esc, torch.bool)):
        req(t.device == B.device and t.dtype == tdt
            and tuple(t.shape) == (k,) and t.is_contiguous(),
            "vc-round kernel: {} must be a contiguous ({},) {} tensor on {}",
            name, k, tdt, B.device)


def fused_vc_round(ops, B, cert, best, stall, esc, thrw, route=None):
    """The refine round of ``models/varying_coefficient.py::_VcBatchOps``
    (``ops``: its shared X and y, the lanes' weights, powers, diagonals,
    Lipschitz bounds, momentum coefficients, stall patience and options)
    in one launch; CUDA tensors launch the kernel (or raise), CPU tensors
    run the plain twin.  ``route`` forces route 0 or 1 (default: the
    planned one).  Returns ``(B, R, mx, cert, best, stall, esc)`` as
    ``ops.round_plain``."""
    if not B.is_cuda:
        return ops.round_plain(B, cert, best, stall, esc, thrw)
    return _launch(ops, B, cert, best, stall, esc, thrw, route)


def _launch(ops, B, cert, best, stall, esc, thrw, route=None):
    global LAUNCHES
    X, y = ops.X, ops.y
    require_inputs(X, y, ops.w, ops.dpow, ops.sc, ops.Lt, ops.adiag,
                   ops.xwnorm, thrw, B, cert, best, stall, esc)
    k, ep = B.shape
    n, p = X.shape
    q1 = ep // p
    dt, dev, item = B.dtype, B.device, B.element_size()
    iters = len(ops.coefs)
    optin = _build.smem_optin(dev)
    if route is None:
        route = pick_route(n, p, q1, item, optin)
    smem = smem_bytes(n, p, q1, item, route)
    _build.require(smem <= optin,
                   "vc-round kernel: {} bytes of shared memory at n = {}, "
                   "p = {}, q1 = {} on route {} (the card allows {})", smem,
                   n, p, q1, route, optin)
    Bo = torch.empty_like(B)
    R = torch.empty((k, n), dtype=dt, device=dev)
    vals = torch.empty((2, k), dtype=dt, device=dev)          # mx, best
    flags = torch.empty((2, k), dtype=torch.bool, device=dev)  # cert, esc
    stall_o = torch.empty_like(stall)
    scratch = (torch.empty((k, n, q1), dtype=dt, device=dev) if route
               else None)
    mom = _build.momentum_table(ops.coefs, dt, dev)
    lib = _build.library()
    fn = lib.cdt_vc_round_f32 if dt == torch.float32 else \
        lib.cdt_vc_round_f64
    P = _build.ptr
    tol = float(ops.opts.opt_tol)
    # the lanes this launch refines, counted after the entry point returns
    # (an operation made only while a profiler runs)
    live = ~cert if host.profiling() else None
    with host.mark("vc_round", later=live, k=k, n=n, p=p, q1=q1,
                   iters=iters, x_item=X.element_size(), route=route):
        err = fn(P(X), P(y), P(ops.w), P(ops.dpow), P(ops.sc), P(ops.Lt),
                 P(ops.adiag), P(ops.xwnorm), P(thrw), P(B), P(cert),
                 P(best), P(stall), P(esc), P(mom), P(scratch), P(Bo), P(R),
                 P(vals), P(flags), vals.data_ptr() + k * item,
                 P(stall_o), flags.data_ptr() + k, k, n, p, q1, iters,
                 route, int(ops.patience), smem, tol, 4 * tol,
                 _build.stream(dev))
    _build.check(err, "vc_round")
    LAUNCHES += 1
    if _build.NAN_CHECK:
        _build.check_nans("vc_round", Bo, R)
    return Bo, R, vals[0], flags[0], vals[1], stall_o, flags[1]
