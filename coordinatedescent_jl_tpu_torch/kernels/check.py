"""K3/K4: the fused KKT full check, phases A and B (``csrc/check.cu``),
and their plain twins.  Least-squares kind, float32 only.

Replace ``coordinatedescent_jl_tpu/ops/pallas_check.py:check_phase_a`` and
``:check_phase_b``.  Phase A evaluates the whole no-refresh check — the
gap-safe screen, drift-ball certification, the stale potential steps, the
noise floor and the maxH / activation reductions — and emits the ``need``
refresh mask; phase B re-evaluates the steps with the refreshed gradient.
Both plain twins call the same cores as the plain check
(``ops/block_cd.py``: ``_gap_safe_core``, ``_stale_core_ls``,
``_habs_reduce_core``, ``_ls_candidate``).

Design on the H100 (the CUDA source has the details): past 8 block rows
one cooperative launch per call spreads the rows over the card, a warp
per row and 16-byte loads, in CTAs of 256 threads laid out by
:func:`plan_check`.  The screen's global terms (phase A) and the final
``maxh`` are per-CTA partials that meet at a grid barrier and are then
combined in a fixed order, so results are deterministic with no atomics;
compiled without multiply-add contraction so each elementwise operation
rounds as PyTorch's does and the masks equal the twins'.  Bounded by
latency (a launch and one or two grid barriers): a call reads about 2.8 MB
at p = 100K, 0.8 µs at the card's memory rate.  At most 8 rows (the plan's
grid is one CTA: the varying-coefficient scan's one block, any small
solve or working set) take the one-CTA route (``CheckPlan.cta``): the same
kernel body as a plain launch of one CTA, no grid barrier, no residency
query and no partials buffer, the screen's terms and ``maxh`` combined in
shared memory; its layout is the cooperative route's at one CTA, so its
outputs are that route's bit for bit.  The JAX package gates the
fused check on VMEM (``fused_check_fits``); the H100 has no such limit at
these sizes (the grid strides over any number of rows), so the only gate
here is float32.

Masks are returned as float {0, 1} tensors of shape ``(nb,)``; ``maxh`` is
a 0-d tensor.  ``LAUNCHES_A``/``LAUNCHES_B`` count kernel launches, and
``LAUNCHES_SHAPE[("a" or "b", nb, one-CTA route)]`` the same launches by
rows and route (:func:`cta_launches` sums those on the one-CTA route).
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build
from ..ops.block_cd import (_gap_safe_core, _habs_reduce_core,
                            _ls_candidate, _stale_core_ls)

LAUNCHES_A = 0
LAUNCHES_B = 0
LAUNCHES_SHAPE = collections.Counter()
# the kernels' shape (csrc/check.cu): warps (block rows owned at once) per
# 256-thread CTA, coordinates of a row one warp loads at once (4 a lane),
# and float partials per CTA
_CK_WARPS = 8
_CK_CHUNK = 128
_CK_PART = 4


def cta_launches(phase: str) -> int:
    """The launches of ``phase`` (``"a"`` or ``"b"``) on the one-CTA
    route."""
    return sum(v for (ph, _, cta), v in LAUNCHES_SHAPE.items()
               if ph == phase and cta)


class CheckPlan(NamedTuple):
    grid: int    # co-resident CTAs
    rows: int    # block rows a warp owns, at most (rows stride the warps)
    keep: bool   # a warp owns one row of one chunk: phase A keeps its
    #              inputs in registers between the screen and the row pass
    # the cooperative route even at one CTA: a test, ``chip_smoke.py`` or
    # ``kernel_ab.py`` holds the one-CTA route against it
    coop: bool = False

    @property
    def cta(self) -> bool:
        """The one-CTA route: a plain launch, wherever the grid is one CTA
        (``nb <= 8``) and the cooperative route is not forced."""
        return self.grid == 1 and not self.coop


@functools.lru_cache(maxsize=64)
def plan_check(nb: int, B: int, sms: int, resident: int) -> CheckPlan:
    """K3/K4's launch plan: a CTA per 8 block rows (a warp per row), at
    most ``sms * resident`` CTAs (``resident``: the kernel's CTAs one SM
    holds at once, so the cooperative grid is co-resident); past that
    the rows stride over the warps; a grid of one CTA (``nb <= 8``) is the
    one-CTA route (``CheckPlan.cta``).  Mirrors ``csrc/check.cu``: the
    kernel keeps a row in registers when every warp owns at most one row
    and ``B <= 128``."""
    grid = max(1, min(-(-nb // _CK_WARPS), sms * resident))
    rows = -(-nb // (grid * _CK_WARPS))
    return CheckPlan(grid, rows, rows == 1 and B <= _CK_CHUNK)


def _resident(phase_b: bool, index: int) -> int:
    """CTAs of phase A's or B's kernel one SM of device ``index`` holds at
    once (the C side's cached occupancy query)."""
    ctas = ctypes.c_int(0)
    with torch.cuda.device(index):
        _build.check(_build.library().cdt_check_resident_f32(
            int(phase_b), ctypes.byref(ctas)), "check_resident")
    return ctas.value // _build.sm_count(torch.device("cuda", index))


@functools.lru_cache(maxsize=64)
def _plan(phase_b: bool, nb: int, B: int, index: int) -> CheckPlan:
    return plan_check(nb, B, _build.sm_count(torch.device("cuda", index)),
                      _resident(phase_b, index))


def _check_inputs(name, dev, tensors):
    """The kernels take contiguous float32 tensors on ``dev``: plain
    comparisons on every call (hundreds a solve), the message built only
    on failure."""
    for key, t, shape in tensors:
        if not (t.device == dev and t.dtype == torch.float32
                and t.shape == shape and t.is_contiguous()):
            raise ValueError(
                f"{name}: {key} must be a contiguous float32 {tuple(shape)} "
                f"tensor on {dev}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")


def check_phase_a(c, beta, drift, adiag, lamw, validf, xwnorm, scal, *,
                  screen: bool, plan: CheckPlan | None = None):
    """One-kernel no-refresh full check.  ``scal`` is the device row
    ``[λ0, n, ‖r‖², r'y, tol]``.  Returns ``(need, use_bound, cand, bound,
    maxh, active)``.  ``plan`` (default the planner's) lets a test or
    ``chip_smoke.py`` launch the other route at one CTA."""
    if not c.is_cuda:
        return check_phase_a_plain(c, beta, drift, adiag, lamw, validf,
                                   xwnorm, scal, screen=screen)
    global LAUNCHES_A
    nb, B = c.shape
    dev = c.device
    sq, row = c.shape, (nb,)
    _check_inputs("check phase A", dev, (
        ("c", c, sq), ("beta", beta, sq), ("drift", drift, row),
        ("adiag", adiag, sq), ("lamw", lamw, sq), ("validf", validf, sq),
        ("xwnorm", xwnorm, sq), ("scal", scal, (5,))))
    if plan is None:
        plan = _plan(False, nb, B, dev.index)
    cta = plan.cta
    # one allocation: bound, the need / ub / cand / active rows, then maxh
    # and, on the cooperative route, the grid's partials
    nbB = nb * B
    npart = 0 if cta else _CK_PART * plan.grid
    out = torch.empty((nbB + 4 * nb + 1 + npart,), dtype=torch.float32,
                      device=dev)
    o = out.data_ptr()
    need, ub, cand, active, maxh = (o + 4 * (nbB + i * nb) for i in range(5))
    err = _build.library().cdt_check_a_f32(
        c.data_ptr(), beta.data_ptr(), drift.data_ptr(), adiag.data_ptr(),
        lamw.data_ptr(), validf.data_ptr(), xwnorm.data_ptr(),
        scal.data_ptr(), need, ub, cand, o, maxh, active,
        maxh + 4 if npart else None, nb, B, int(bool(screen)), plan.grid,
        int(cta), _build.stream(dev))
    _build.check(err, "check_a")
    LAUNCHES_A += 1
    LAUNCHES_SHAPE["a", nb, cta] += 1
    if _build.NAN_CHECK:
        _build.check_nans("check_a", out[:nbB + 4 * nb + 1])
    # the six outputs' views from one call (every view op costs host time)
    bound, need, ub, cand, active, tail = out.split_with_sizes(
        (nbB, nb, nb, nb, nb, 1 + npart))
    return need, ub, cand, bound.view(nb, B), tail[0], active


def check_phase_b(c_new, beta, bound, ubf, candf, adiag, lamw, validf,
                  xwnorm, scal, *, plan: CheckPlan | None = None):
    """Post-refresh step re-evaluation + reductions in one kernel.  Returns
    ``(maxh, active)``.  ``plan`` as :func:`check_phase_a`'s."""
    if not c_new.is_cuda:
        return check_phase_b_plain(c_new, beta, bound, ubf, candf, adiag,
                                   lamw, validf, xwnorm, scal)
    global LAUNCHES_B
    nb, B = c_new.shape
    dev = c_new.device
    sq, row = c_new.shape, (nb,)
    _check_inputs("check phase B", dev, (
        ("c", c_new, sq), ("beta", beta, sq), ("bound", bound, sq),
        ("ubf", ubf, row), ("candf", candf, row), ("adiag", adiag, sq),
        ("lamw", lamw, sq), ("validf", validf, sq), ("xwnorm", xwnorm, sq),
        ("scal", scal, (5,))))
    if plan is None:
        plan = _plan(True, nb, B, dev.index)
    cta = plan.cta
    # one allocation: active, maxh, then (cooperative route) the partials
    npart = 0 if cta else _CK_PART * plan.grid
    out = torch.empty((nb + 1 + npart,), dtype=torch.float32, device=dev)
    o = out.data_ptr()
    err = _build.library().cdt_check_b_f32(
        c_new.data_ptr(), beta.data_ptr(), bound.data_ptr(), ubf.data_ptr(),
        candf.data_ptr(), adiag.data_ptr(), lamw.data_ptr(),
        validf.data_ptr(), xwnorm.data_ptr(), scal.data_ptr(), o + 4 * nb,
        o, o + 4 * (nb + 1) if npart else None, nb, B, plan.grid,
        int(cta), _build.stream(dev))
    _build.check(err, "check_b")
    LAUNCHES_B += 1
    LAUNCHES_SHAPE["b", nb, cta] += 1
    if _build.NAN_CHECK:
        _build.check_nans("check_b", out[:nb + 1])
    return out[nb], out[:nb]


# ---------------------------------------------------------------------------
# Plain twins
# ---------------------------------------------------------------------------


def check_phase_a_plain(c, beta, drift, adiag, lamw, validf, xwnorm, scal, *,
                        screen: bool):
    lam0, n_scale, rn2, ry, tol = scal[0], scal[1], scal[2], scal[3], scal[4]
    dt = c.dtype
    nb = c.shape[0]
    valid = validf > 0
    drift2 = drift[:, None]
    cand2 = (_gap_safe_core(c, beta, drift2, adiag, lamw, valid, lam0,
                            n_scale, rn2, ry) if screen
             else torch.ones((nb, 1), dtype=torch.bool, device=c.device))
    certified2, bound, h_stale = _stale_core_ls(
        c, beta, drift2, adiag, lamw, valid, xwnorm, lam0, n_scale, tol)
    stale2 = drift2 > 0
    need2 = cand2 & stale2 & ~certified2
    ub2 = stale2 & certified2
    maxh, active2 = _habs_reduce_core(h_stale, bound, ub2, cand2, beta,
                                      xwnorm, rn2, tol)
    return (need2[:, 0].to(dt), ub2[:, 0].to(dt), cand2[:, 0].to(dt), bound,
            maxh, active2[:, 0].to(dt))


def check_phase_b_plain(c_new, beta, bound, ubf, candf, adiag, lamw, validf,
                        xwnorm, scal):
    lam0, n_scale, rn2, tol = scal[0], scal[1], scal[2], scal[4]
    valid = validf > 0
    h = torch.where(valid,
                    _ls_candidate(beta, c_new, adiag, lam0, lamw, n_scale)
                    - beta, torch.zeros_like(beta))
    maxh, active2 = _habs_reduce_core(h, bound, ubf[:, None] > 0,
                                      candf[:, None] > 0, beta, xwnorm, rn2,
                                      tol)
    return maxh, active2[:, 0].to(c_new.dtype)
