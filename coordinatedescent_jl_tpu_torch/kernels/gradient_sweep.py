"""The gradient sweeps ``c = Xw'r``: K2, the restricted sweep
(``csrc/gradient_sweep.cu``), and K5, the dense sweep
(``csrc/dense_sweep.cu``), with their plain twins.

K2 replaces ``coordinatedescent_jl_tpu/ops/pallas_block.py:restricted_gradient_sweep``
(kernel ``_make_rsweep_kernel``): ``c[b] = Xw_b'r`` only for the blocks
with ``need[b]``, the others keep ``c_prev``.  The needed blocks are
ordered first by a stable argsort of ``~need`` on the device; the kernel's
grid is (needed-block slot, row chunk) into a partials buffer, and a
second kernel adds each block's partials in chunk order into a clone of
``c_prev``.  It is bounded by device-memory bandwidth (every needed block
is read once).

K5 replaces ``pallas_block.py:fused_gradient_sweep`` (kernel
``_make_sweep_kernel``): ``c = Xw'r`` for every column, X streamed once,
in two instantiations of one kernel —

- :func:`fused_gradient_sweep`: the blocked ``(nb, n, B)`` layout, one
  dtype throughout (the engine's dense refresh, ``_full_gradient_c``);
- :func:`grad_f64`: the dense ``(n, p)`` float32 design, float64 ``r``,
  float64 accumulation and output (the certificate of the f64 polish and
  the compensated gaps).

Bounded by device-memory bandwidth (X read once): 16-byte loads over
(column tile, row slice) items laid out by :func:`plan_dense_sweep`, in
one of three routes.  At the bench's 782 tiles a slice is all n rows: a
persistent grid, one launch, no partials.  Few tiles of few rows (the
varying-coefficient scan's one tile of 500 rows) split into S <= 16
slices that form one thread-block cluster a tile: the slices' partials
stay in shared memory and CTA 0 adds them in order (one launch).  The
8-tile working set at n = 10K splits 66 ways and adds the slices' partials
in order in a second launch.

The loadings sweep (LD), ``Σ_i w_i x_ij²`` with ``w = r²`` (the feasible
Lasso's penalty loadings before their ``sqrt(· / n)``), is K5's kernel
with each element squared in registers (``csrc/dense_sweep.cu``'s
``loadings_kernel``), in K5's two forms and under K5's planner:
:func:`loadings_sweep` on the blocked design in its own dtype
(``utils/helpers.py::get_loadings_blocked``) and :func:`loadings_f64_sweep`
on the dense design with float64 weights and sums
(``ops/compensated.py::loadings_f64``).  One launch and one read of X a
sweep, where the plain twins square a copy of each block of columns.

``LAUNCHES`` (K2), ``LAUNCHES_DENSE`` (K5 blocked), ``LAUNCHES_F64``
(K5 f64) and ``LAUNCHES_LOADINGS`` (both loadings forms) count the
wrapper calls that launched a kernel, and ``LAUNCHES_DENSE_SHAPE[(nb,
n)]`` K5's blocked launches by blocks and rows.
"""

from __future__ import annotations

import collections
import functools
from typing import NamedTuple

import torch

from . import _build
from ..utils import host

LAUNCHES = 0
LAUNCHES_DENSE = 0
LAUNCHES_F64 = 0
LAUNCHES_DENSE_SHAPE = collections.Counter()
LAUNCHES_LOADINGS = 0
_ROW_CHUNK = 256   # K2: rows per partial-sum CTA
# K5's plan (csrc/dense_sweep.cu): columns per work item, CTAs (of 128
# threads) per SM that the persistent grid may hold, the CTAs per SM that
# the work items should give before the rows are split, the fewest rows a
# slice may have (the partials of more slices cost their HBM traffic), the
# CTAs of the largest cluster (csrc/common.cuh MAX_CLUSTER), and the fewest
# rows of a slice inside one cluster (the f32 blocked sweep of n <=
# _SW_CLUSTER_MAX_N rows)
_SW_TILE = 128
_SW_CTAS_PER_SM = 16
_SW_FILL = 4
_SW_MIN_ROWS = 128
_MAX_CLUSTER = _build.MAX_CLUSTER
_SW_CLUSTER_ROWS = 32
_SW_CLUSTER_MAX_N = _MAX_CLUSTER * _SW_MIN_ROWS
# columns per float64 chunk of grad_f64_plain: bounds the f64 copy of X to
# n·8192·8 bytes (655 MB at n = 10K) instead of a whole f64 X
_F64_COLS = 8192
# blocks per squared copy of loadings_sweep_plain (82 MB at n = 10K, B =
# 128, float32)
_LD_BLOCKS = 16


def restricted_gradient_sweep(Xwb, r, need, c_prev, *, n_need=None):
    """Refresh ``c[b] = Xw_b'r`` for the blocks with ``need[b]``.  ``n_need``
    (the host count of needed blocks) saves a host read when the caller
    already has it.  CUDA tensors launch the kernels (or raise); CPU
    tensors run the plain twin."""
    if not Xwb.is_cuda:
        return restricted_gradient_sweep_plain(Xwb, r, need, c_prev)
    global LAUNCHES
    req = _build.require
    nb, n, B = Xwb.shape
    dt = Xwb.dtype
    req(dt in (torch.float32, torch.float64),
        f"gradient-sweep kernel: dtype {dt} (float32/float64 only)")
    req(B <= 1024, f"gradient-sweep kernel: block width {B} > 1024")
    for name, t, shape in (("Xwb", Xwb, (nb, n, B)), ("r", r, (n,)),
                           ("c_prev", c_prev, (nb, B))):
        req(t.is_cuda and t.device == Xwb.device and t.dtype == dt,
            f"gradient-sweep kernel: {name} must be {dt} on {Xwb.device}")
        req(tuple(t.shape) == shape and t.is_contiguous(),
            f"gradient-sweep kernel: {name} must be contiguous {shape}")
    req(need.is_cuda and need.dtype == torch.bool and need.shape == (nb,),
        "gradient-sweep kernel: need must be a (nb,) bool CUDA tensor")
    if n_need is None:
        n_need = host.item(torch.sum(need))
    out = c_prev.clone()
    if n_need == 0:
        return out
    order = torch.argsort((~need).to(torch.int32), stable=True).to(
        torch.int32)
    nr = -(-n // _ROW_CHUNK)
    part = torch.empty((n_need, nr, B), dtype=dt, device=Xwb.device)
    lib = _build.library()
    fn = lib.cdt_rsweep_f32 if dt == torch.float32 else lib.cdt_rsweep_f64
    P = _build.ptr
    err = fn(P(Xwb), P(r), P(order), P(part), P(out), int(n_need), n, B,
             _ROW_CHUNK, _build.stream())
    _build.check(err, "rsweep")
    LAUNCHES += 1
    if _build.NAN_CHECK:
        _build.check_nans("rsweep", out)
    return out


def restricted_gradient_sweep_plain(Xwb, r, need, c_prev):
    """Plain twin: the needed blocks' ``Xw_b'r``, the others from
    ``c_prev``."""
    out = c_prev.clone()
    idx = torch.nonzero(need).reshape(-1)
    out[idx] = torch.matmul(r, Xwb[idx])
    return out


class SweepPlan(NamedTuple):
    tiles: int   # column tiles of _SW_TILE columns (a block's last is ragged)
    split: int   # row slices per tile (1: no partials, one launch)
    rows: int    # rows per slice
    grid: int    # CTAs: of the persistent grid (the kernel caps it further
                 # by the occupancy the card reports), or every item
    cluster: bool = False   # a tile's slices are one cluster (one launch)


@functools.lru_cache(maxsize=64)
def plan_dense_sweep(nb: int, n: int, W: int, sms: int,
                     resplit: bool = False,
                     max_cluster: int = _MAX_CLUSTER) -> SweepPlan:
    """K5's launch plan for ``nb`` blocks of ``n`` rows and row stride
    ``W`` on a card with ``sms`` multiprocessors: the rows are split only
    when the column tiles alone cannot give ``_SW_FILL`` CTAs per SM (the
    8-tile working set), and never below ``_SW_MIN_ROWS`` rows a slice.
    ``resplit`` (the f32 blocked sweep; the f64 forms keep the sums'
    order): at most ``_SW_CLUSTER_MAX_N`` rows split into up to ``most``
    slices of ``_SW_CLUSTER_ROWS`` or more, ``most`` the smaller of
    ``_MAX_CLUSTER`` and ``max_cluster`` (the largest cluster the card
    holds, ``_build.largest_cluster``).  Where a tile has 2 to ``most``
    slices they are one cluster, and the grid is every item; more slices
    add their partials in a second launch."""
    most = min(_MAX_CLUSTER, max_cluster)
    tiles = nb * -(-W // _SW_TILE)
    want = _SW_FILL * sms
    split = 1
    if tiles < want:
        fill = -(-want // tiles)
        if resplit and n <= _SW_CLUSTER_MAX_N:
            split = max(1, min(most, fill, -(-n // _SW_CLUSTER_ROWS)))
        else:
            split = max(1, min(fill, n // _SW_MIN_ROWS))
    rows = -(-n // split)
    split = -(-n // rows)            # no empty slice
    if 1 < split <= most:
        return SweepPlan(tiles, split, rows, tiles * split, True)
    return SweepPlan(tiles, split, rows,
                     min(tiles * split, _SW_CTAS_PER_SM * sms))


def _dense_sweep(fn, X, r, out, nb: int, n: int, W: int, name: str, plan):
    """Launch one K5 instantiation: ``out`` (nb·W columns) ← X'r over
    row stride ``W``; a partials buffer only when the plan splits rows
    outside a cluster."""
    part = (torch.empty((plan.split, nb * W), dtype=out.dtype,
                        device=out.device)
            if plan.split > 1 and not plan.cluster else None)
    err = fn(X.data_ptr(), r.data_ptr(),
             None if part is None else part.data_ptr(), out.data_ptr(), nb, n,
             W, plan.split, plan.rows, plan.grid, int(plan.cluster),
             _build.stream(out.device))
    _build.check(err, name)


def _require_sweep_inputs(name, X, r, xdtypes, rdtype, n):
    req = _build.require
    req(X.dtype in xdtypes, "{} kernel: X dtype {}", name, X.dtype)
    req(X.is_contiguous(), "{} kernel: X must be contiguous", name)
    req(r.device == X.device and r.dtype == rdtype and r.shape == (n,)
        and r.is_contiguous(), "{} kernel: r must be contiguous ({},) {} "
        "on {}", name, n, rdtype, X.device)


@functools.lru_cache(maxsize=64)
def _card_plan(entry: str, nb: int, n: int, W: int, index: int,
               resplit: bool) -> SweepPlan:
    """:func:`plan_dense_sweep` on device ``index``: its SMs, and the
    largest cluster of the instantiation ``entry`` it holds."""
    return plan_dense_sweep(
        nb, n, W, _build.sm_count(torch.device("cuda", index)), resplit,
        _build.largest_cluster(f"{entry}_clusters", index))


def sweep_plan(Xwb) -> SweepPlan:
    """The plan :func:`fused_gradient_sweep` launches for the blocked
    design ``Xwb`` (a CUDA tensor): the f32 sweep re-splits small n; a
    cluster is at most the largest the card holds."""
    nb, n, B = Xwb.shape
    f32 = Xwb.dtype == torch.float32
    return _card_plan("cdt_dense_sweep_f32" if f32 else "cdt_dense_sweep_f64",
                      nb, n, B, Xwb.device.index, f32)


def fused_gradient_sweep(Xwb, r, *, plan: SweepPlan | None = None):
    """Blocked ``c[b] = Xw_b'r`` for every block, ``(nb, B)``.  CUDA tensors
    launch K5 (or raise); CPU tensors run the plain twin.  ``plan``
    (default :func:`sweep_plan`'s) lets a test or ``chip_smoke.py`` launch
    another route at the same slices."""
    if not Xwb.is_cuda:
        return fused_gradient_sweep_plain(Xwb, r)
    global LAUNCHES_DENSE
    nb, n, B = Xwb.shape
    _require_sweep_inputs("dense-sweep", Xwb, r,
                          (torch.float32, torch.float64), Xwb.dtype, n)
    out = torch.empty((nb, B), dtype=Xwb.dtype, device=Xwb.device)
    lib = _build.library()
    fn = (lib.cdt_dense_sweep_f32 if Xwb.dtype == torch.float32
          else lib.cdt_dense_sweep_f64)
    _dense_sweep(fn, Xwb, r, out, nb, n, B, "dense_sweep",
                 plan or sweep_plan(Xwb))
    LAUNCHES_DENSE += 1
    LAUNCHES_DENSE_SHAPE[nb, n] += 1
    if _build.NAN_CHECK:
        _build.check_nans("dense_sweep", out)
    return out


def fused_gradient_sweep_plain(Xwb, r):
    """Plain twin: one batched product straight off the ``(nb, n, B)``
    layout (``torch.einsum`` would first copy the whole blocked design into
    an ``(n, nb·B)`` layout)."""
    return torch.matmul(r, Xwb)


def grad_f64(X, r64, *, plan: SweepPlan | None = None):
    """``X'r`` with float64 accumulation, ``(p,)`` float64, for a dense
    ``(n, p)`` design ``X`` (float32 or float64) and a float64 ``r``.  CUDA
    tensors launch K5's f64-accumulating instantiation (or raise); CPU
    tensors run the plain twin.  ``plan`` as :func:`fused_gradient_sweep`'s
    (default: :func:`plan_dense_sweep`'s slices, never re-split).  Each
    call is marked ``k5f64`` with its shape."""
    n, p = X.shape
    with host.mark("k5f64", n=n, p=p, x_item=X.element_size()):
        if not X.is_cuda:
            return grad_f64_plain(X, r64)
        return _grad_f64_card(X, r64, plan)


def _grad_f64_card(X, r64, plan):
    global LAUNCHES_F64
    n, p = X.shape
    _require_sweep_inputs("grad_f64", X, r64,
                          (torch.float32, torch.float64), torch.float64, n)
    out = torch.empty((p,), dtype=torch.float64, device=X.device)
    lib = _build.library()
    fn = lib.cdt_grad64_f32 if X.dtype == torch.float32 else \
        lib.cdt_grad64_f64
    if plan is None:
        plan = _card_plan(fn.__name__, 1, n, p, X.device.index, False)
    _dense_sweep(fn, X, r64, out, 1, n, p, "grad64", plan)
    LAUNCHES_F64 += 1
    if _build.NAN_CHECK:
        _build.check_nans("grad64", out)
    return out


def grad_f64_plain(X, r64):
    """Plain twin: ``r'X`` with X widened to float64 a column chunk at a
    time."""
    p = X.shape[1]
    return torch.cat([r64 @ X[:, j:j + _F64_COLS].to(torch.float64)
                      for j in range(0, p, _F64_COLS)])


def loadings_sweep(Xb, w, *, plan: SweepPlan | None = None):
    """Blocked ``Σ_i w_i Xb[b, i, k]²`` for every column, ``(nb, B)``, in
    ``Xb``'s dtype (``w`` the squared residual, of that dtype).  CUDA
    tensors launch the loadings kernel (or raise); CPU tensors run the
    plain twin.  ``plan`` as :func:`fused_gradient_sweep`'s (default: K5's
    blocked plan for this shape, the float32 form re-splitting small n)."""
    if not Xb.is_cuda:
        return loadings_sweep_plain(Xb, w)
    global LAUNCHES_LOADINGS
    nb, n, B = Xb.shape
    _require_sweep_inputs("loadings", Xb, w, (torch.float32, torch.float64),
                          Xb.dtype, n)
    out = torch.empty((nb, B), dtype=Xb.dtype, device=Xb.device)
    lib = _build.library()
    f32 = Xb.dtype == torch.float32
    fn = lib.cdt_loadings_f32 if f32 else lib.cdt_loadings_f64
    if plan is None:
        plan = _card_plan(fn.__name__, nb, n, B, Xb.device.index, f32)
    _dense_sweep(fn, Xb, w, out, nb, n, B, "loadings", plan)
    LAUNCHES_LOADINGS += 1
    if _build.NAN_CHECK:
        _build.check_nans("loadings", out)
    return out


def loadings_sweep_plain(Xb, w):
    """Plain twin: one batched product of ``w`` with the squares of
    ``_LD_BLOCKS`` blocks at a time (no design-sized ``X∘X``)."""
    return torch.cat([torch.matmul(w, Xb[i:i + _LD_BLOCKS].square())
                      for i in range(0, Xb.shape[0], _LD_BLOCKS)])


def loadings_f64_sweep(X, w64, *, col_chunk: int = 2048,
                       plan: SweepPlan | None = None):
    """``Σ_i w64_i X_ij²`` with float64 squares and accumulation, ``(p,)``
    float64, for a dense ``(n, p)`` design ``X`` (float32 or float64) and
    float64 weights.  CUDA tensors launch the loadings kernel's
    float64-accumulating form (or raise); CPU tensors run the plain twin,
    ``col_chunk`` columns at a time.  ``plan`` as :func:`grad_f64`'s."""
    if not X.is_cuda:
        return loadings_f64_sweep_plain(X, w64, col_chunk)
    global LAUNCHES_LOADINGS
    n, p = X.shape
    _require_sweep_inputs("loadings_f64", X, w64,
                          (torch.float32, torch.float64), torch.float64, n)
    out = torch.empty((p,), dtype=torch.float64, device=X.device)
    lib = _build.library()
    fn = lib.cdt_loadings64_f32 if X.dtype == torch.float32 else \
        lib.cdt_loadings64_f64
    if plan is None:
        plan = _card_plan(fn.__name__, 1, n, p, X.device.index, False)
    _dense_sweep(fn, X, w64, out, 1, n, p, "loadings64", plan)
    LAUNCHES_LOADINGS += 1
    if _build.NAN_CHECK:
        _build.check_nans("loadings64", out)
    return out


def loadings_f64_sweep_plain(X, w64, col_chunk: int = 2048):
    """Plain twin: per chunk of ``col_chunk`` columns one float64 copy,
    its square and one float64 product (no design-sized temporary)."""
    return torch.cat([w64 @ X[:, c:c + col_chunk].to(torch.float64).square()
                      for c in range(0, X.shape[1], col_chunk)])
