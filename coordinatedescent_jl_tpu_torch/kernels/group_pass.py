"""The group engine's active pass (``csrc/group_pass.cu``), ``GP``.

Replaces no Pallas kernel: the JAX engine's group visit
(``coordinatedescent_jl_tpu/ops/group_cd.py``) runs outside Pallas.  The
plain twin, ``ops/group_cd.py::_group_active_pass_plain``, runs a pass as a
host loop over the active blocks, ~268 eager operations a visit (16 FISTA
steps of 128-wide products, adds, divides and the group prox, then the zero
snap; ~19,000 launches a ``group_lasso`` at n = 10,000, p = 100,000, G = 8).
Here the whole pass is one cooperative launch on K1's design
(``kernels/active_pass.py``): up to one CTA an SM, each owning a slice of
the rows of ``r`` for the pass; the visit order walked on the device from
``order`` and the ``active`` flags, so nothing is read to the host; per
visit the CTAs' partial sums of ``c0 = Xw_b'r``, one grid barrier, the
block's FISTA steps with the group prox and its zero snap solved
redundantly in every CTA (the Gram's rows in registers, K1's warp layout),
then each CTA's residual rows updated.  The arithmetic is the plain twin's,
operation for operation, with its sums in another order.  It takes the
three kinds of the engine: ``wls`` reads ``c0`` from ``Xwb`` and updates
``r`` from ``Xb``; ``sqrt`` has ``n_scale = ρ`` in its thresholds, which
the wrapper computes for every block as one ``(nb, k)`` tensor.  Any group
width with ``B = k·G ≤ 128``; the engine keeps the plain twin for wider
blocks.

``LAUNCHES`` counts the wrapper calls that launched the kernel (one an
active pass of the group engine on the card).  While a profiler runs, each
launch sits in the mark ``cdt#group_pass n= B= G= iters= x_item=``
(``utils/host.py``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import _build
from .active_pass import SMEM_OPTIN_H100, _rows
from ..utils import host

LAUNCHES = 0
MAX_B = 128          # widest block: warp_dot's product covers 128 lanes
_THREADS = 512       # csrc/common.cuh DOT_THREADS


class GroupPassPlan(NamedTuple):
    grid: int      # co-resident CTAs
    rows: int      # rows of r (and of each X_b) a CTA owns
    keep_x: bool   # the CTA keeps its rows of X_b in shared memory
    keep_r: bool   # ... and its rows of r (else they live in r_out)
    smem: int      # dynamic shared memory per CTA, bytes


def smem_bytes(B: int, rows: int, keep_x: bool, keep_r: bool, iters: int,
               itemsize: int) -> int:
    """Bytes of ``csrc/group_pass.cu::gp_layout`` (the launch refuses any
    other count): a 16-byte header, the row-group sums (16 bytes a
    thread), eight 128-long vectors, 32 reduction slots, the momentum
    coefficients and the kept rows of r, each rounded up to 16 bytes, and
    the kept rows of X_b."""
    v = 16 // itemsize

    def up(x):
        return -(-x // v) * v

    elems = (_THREADS * v + 8 * MAX_B + 32 + up(iters)
             + (up(rows) if keep_r else 0) + (rows * B if keep_x else 0))
    return 16 + itemsize * elems


@functools.lru_cache(maxsize=64)
def plan_group_pass(n: int, B: int, itemsize: int, iters: int, sms: int,
                    smem_limit: int = SMEM_OPTIN_H100) -> GroupPassPlan:
    """The launch plan: K1's cooperative grid (one CTA an SM, fewer when
    ``n`` gives a CTA under 32 rows); each keeps its rows of r, then its
    rows of X_b, in shared memory while they fit under ``smem_limit``."""
    grid, rows = _rows(n, sms)
    base = smem_bytes(B, rows, False, False, iters, itemsize)
    if base > smem_limit:
        raise ValueError(f"group-pass kernel: {base} bytes of shared memory "
                         f"at {iters} steps > {smem_limit}")
    keep_r = smem_bytes(B, rows, False, True, iters, itemsize) <= smem_limit
    keep_x = keep_r and smem_bytes(B, rows, True, True, iters,
                                   itemsize) <= smem_limit
    return GroupPassPlan(grid, rows, keep_x, keep_r,
                         smem_bytes(B, rows, keep_x, keep_r, iters, itemsize))


def require_inputs(prob, beta, r, active, order):
    """The shapes, dtypes and layout the kernel takes (raises
    ``ValueError`` on any other): a block of at most 128 lanes holding
    whole groups; float32 or float64 throughout; ``Xb`` / ``Xwb`` ``(nb,
    n, B)``, ``Kb (nb, B, B)``, ``Lb (nb,)``, ``lamw (nb, k)``, ``beta (nb,
    B)``, ``r (n,)``, all contiguous; ``valid (nb, B)`` and ``active
    (nb,)`` bool, ``order (nb,)`` int64; all on one CUDA device."""
    req = _build.require
    nb, B = prob.valid.shape
    k = prob.lamw.shape[1]
    n = r.shape[0]
    dt = beta.dtype
    req(1 <= B <= MAX_B and B % k == 0,
        "group-pass kernel: block width {} with {} groups (at most {} lanes "
        "of whole groups)", B, k, MAX_B)
    req(dt in (torch.float32, torch.float64),
        "group-pass kernel: dtype {} (float32/float64 only)", dt)
    for name, t, shape in (("Xb", prob.Xb, (nb, n, B)),
                           ("Xwb", prob.Xwb, (nb, n, B)),
                           ("Kb", prob.Kb, (nb, B, B)), ("Lb", prob.Lb, (nb,)),
                           ("lamw", prob.lamw, (nb, k)),
                           ("beta", beta, (nb, B)), ("r", r, (n,))):
        req(t.dtype == dt and t.device == beta.device,
            "group-pass kernel: {} must be {} on {}", name, dt, beta.device)
        req(tuple(t.shape) == shape and t.is_contiguous(),
            "group-pass kernel: {} must be contiguous {}", name, shape)
    for name, t, tdt in (("valid", prob.valid, torch.bool),
                         ("active", active, torch.bool),
                         ("order", order, torch.int64)):
        req(t.dtype == tdt and t.device == beta.device and t.is_contiguous()
            and t.shape[0] == nb and t.dim() == (2 if name == "valid" else 1),
            "group-pass kernel: {} must be a contiguous {} tensor on {}",
            name, tdt, beta.device)
    req(beta.is_cuda, "group-pass kernel: the tensors are on {}, not on a "
        "CUDA device (the engine runs the plain twin there)", beta.device)


def fused_group_pass(prob, beta, r, active, lam0, n_scale, order, coefs,
                     plan: GroupPassPlan | None = None):
    """One active pass of the group engine over the blocks of ``order``
    whose ``active`` flag is set, in one launch; returns ``(beta, r,
    maxh)``, ``maxh`` a device scalar.  ``n_scale`` is a float or a 0-d
    device tensor (the sqrt kind's ρ); ``coefs`` the momentum coefficients
    (``ops/prox.py::fista_momentum``).  CUDA tensors only (raises
    otherwise); nothing is read to the host."""
    global LAUNCHES
    require_inputs(prob, beta, r, active, order)
    nb, B = prob.valid.shape
    k = prob.lamw.shape[1]
    n = r.shape[0]
    dt, dev = beta.dtype, beta.device
    w = dt.itemsize
    iters = len(coefs)
    if plan is None:
        plan = plan_group_pass(n, B, w, iters, _build.sm_count(dev),
                               _build.smem_optin(dev))
    # the per-group prox levels of every block, in the plain twin's
    # expression order
    thr = n_scale * lam0 * prob.lamw / torch.clamp_min(prob.Lb, 1e-30)[:, None]
    mom = _build.momentum_table(tuple(coefs), dt, dev)
    out = torch.empty((nb * B + n + 1,), dtype=dt, device=dev)
    part = torch.empty((2 * plan.grid * B,), dtype=dt, device=dev)
    op = out.data_ptr()
    wls = prob.Xwb.data_ptr() != prob.Xb.data_ptr()
    lib = _build.library()
    fn = lib.cdt_group_pass_f32 if dt == torch.float32 else \
        lib.cdt_group_pass_f64
    P = _build.ptr
    with host.mark("group_pass", n=n, B=B, G=B // k, iters=iters, x_item=w):
        err = fn(P(prob.Xb), P(prob.Xwb), P(prob.Kb), P(prob.Lb), P(thr),
                 P(prob.valid), P(order), P(active), P(mom), P(beta), P(r),
                 op, op + nb * B * w, op + (nb * B + n) * w, P(part),
                 nb, n, B, B // k, plan.grid, plan.rows, int(plan.keep_x),
                 int(plan.keep_r), iters, int(wls), plan.smem,
                 _build.stream(dev))
    _build.check(err, "group_pass")
    LAUNCHES += 1
    if _build.NAN_CHECK:
        _build.check_nans("group_pass", out)
    beta2, r2, maxh = out.split_with_sizes((nb * B, n, 1))
    return beta2.view(nb, B), r2, maxh.view(())
