"""The program's host-side observability: counted device→host reads, and
named spans and marks for a profiler.

Counted reads.  The JAX package keeps its epoch loop, passes and checks on
the device (``lax.while_loop`` / ``lax.cond``).  The port runs them as
Python control flow, and every branch on a device value is a device sync.
All of them go through :func:`item` / :func:`tolist`, so a run can report
how many syncs each epoch costs (``COUNTS["host_reads"] /
COUNTS["epochs"]``).

Spans and marks.  :func:`span` and :func:`mark` open a profiler range
(what ``torch.profiler.record_function`` opens) while a profiler runs, and
do nothing else otherwise (one flag check: no range, no name formatted).
The profiler's record is their only store, so they share the device
trace's clock.  A range is opened through PyTorch's light entry,
``torch._C._profiler._RecordFunctionFast``, where the build has it:
``record_function`` goes through the operator dispatcher and costs about
8x as much under a profiler (13 µs a range against 1.7 µs on a CPU), which
at several hundred ranges a problem moved a traced problem's device idle
share by several points.  To see where a call spends its time, run any entry point under
the profiler::

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tcd.lasso(X, y, lam)
    prof.export_chrome_trace("trace.json")

and the Chrome trace shows each phase as a ``cdt:<layer>.<phase>`` range:

- the estimators' entry points: ``est.lasso``, ``est.sqrt_lasso``,
  ``est.scaled_lasso``, ``est.feasible_lasso``, ``est.lasso_path``,
  ``est.locpolyl1``, ``est.group_lasso``, around each call;
- the block engine (``ops/block_cd.py``): ``cd.build_blocked``,
  ``cd.solve`` (``solve_blocked``) with ``cd.lambda_max`` in it, and one
  of ``cd.full_check``, ``cd.compact_pass``, ``cd.active_pass`` an epoch;
- the group engine (``ops/group_cd.py``): ``group.solve`` with
  ``group.build`` and ``group.lambda_max`` in it, and one of
  ``group.full_check``, ``group.active_pass`` an epoch (a pass, not a
  block visit);
- the λ path (``models/lasso_path.py``): ``path.scan``, or
  ``path.batched`` around ``path.coarse_scan`` and ``path.refine`` (a
  chunk of lanes), in which ``path.refine_round`` and
  ``path.union_block_fista``; the feature-sharded path's rounds hold
  ``sharded.union_block_fista``;
- the varying-coefficient grid (``models/varying_coefficient.py``):
  ``vc.scan``, or ``vc.batched`` around ``vc.anchors``, ``vc.refine`` (a
  chunk), in which ``vc.refine_round``, and ``vc.refit``;
- the float64 polishes (``models/polish.py``): ``polish.lasso``,
  ``polish.sqrt_lasso``, ``polish.scaled_lasso``,
  ``polish.feasible_lasso``, ``polish.group_lasso`` around each call,
  ``polish.restricted_solve`` and ``polish.certify`` in each round.

Marks are ranges around one launch or one copy that carry its shape, as
``cdt#<kind> k=v ...``:

- ``cdt#k5f64 n= p= x_item=``: one ``grad_f64`` sweep (K5's float64
  instantiation on the card);
- ``cdt#design_copy bytes=``: one copy of a design that a problem's
  set-up makes (a padding, a blockify, the weighted ``X·w``), with the
  bytes it writes;
- ``cdt#k1 n= B= iters= gram= x_item=``: one launch of the fused active
  pass (``kernels/active_pass.py``); the blocks it visits are counted
  later, under ``k1``;
- ``cdt#group_pass n= B= G= iters= x_item=``: one launch of the group
  engine's active pass (``kernels/group_pass.py``), ``iters`` the FISTA
  steps a visit;
- ``cdt#vc_round k= n= p= q1= iters= x_item= route=``: one launch of the
  varying-coefficient grid's refine round (``kernels/vc_round.py``) over
  ``k`` lanes, ``route`` 0 with X in shared memory, 1 with X read from
  L2; the lanes it refines (those not yet certified) are counted later,
  under ``vc_round``;
- ``cdt#union cap=``: one refine round's union selection
  (``models/lasso_path.py::_refine_chunk``), with the union's capacity
  ``compact_size``; the columns of positive union priority are counted
  later, under ``union``;
- ``cdt#counted <kind>=c,c,...``: what the marks above count later.  A
  mark given ``later=flags`` keeps a reference to ``flags`` (a device
  tensor nothing writes again) and adds no operation and no read there.
  When the outermost :func:`spanned` call returns, the positive entries of
  every kept tensor are counted together (a few operations and one read a
  shape, not among the counted reads), and this range carries the counts,
  each kind's in the order of its marks.  Outside any spanned call a mark
  keeps nothing: a bare launch under a profiler stays one launch with no
  read, and no count.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.autograd import profiler as _profiler

COUNTS = {"host_reads": 0, "epochs": 0}
SPAN_PREFIX = "cdt:"
MARK_PREFIX = "cdt#"

_OFF = contextlib.nullcontext()


def reset():
    for k in COUNTS:
        COUNTS[k] = 0


def item(t):
    """``t.item()``, counted as one host read."""
    COUNTS["host_reads"] += 1
    return t.item()


def tolist(t):
    """``t.tolist()``, counted as one host read."""
    COUNTS["host_reads"] += 1
    return t.tolist()


def numpy(t):
    """``t`` as a numpy array on the host, counted as one host read."""
    COUNTS["host_reads"] += 1
    return t.detach().cpu().numpy()


if hasattr(_profiler, "_is_profiler_enabled"):
    def profiling() -> bool:
        """Whether a profiler is recording."""
        return _profiler._is_profiler_enabled
else:
    profiling = torch._C._autograd._profiler_enabled


def _range(name: str):
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    return (fast or torch.profiler.record_function)(name)


def span(name: str):
    """A context manager: the profiler range ``cdt:<name>`` while a
    profiler runs, a shared no-op otherwise."""
    if not profiling():
        return _OFF
    return _range(SPAN_PREFIX + name)


# the marks' tensors counted when the outermost spanned call returns, and
# how many spanned calls are open under the profiler
_LATER: list = []
_DEPTH = [0]


def spanned(name: str):
    """A decorator: each call of the function inside :func:`span`
    ``(name)``; under a profiler the outermost such call counts what the
    marks inside it kept (``cdt#counted``) once its range has closed."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not profiling():
                return fn(*args, **kwargs)
            _DEPTH[0] += 1
            try:
                with _range(SPAN_PREFIX + name):
                    return fn(*args, **kwargs)
            finally:
                _DEPTH[0] -= 1
                if not _DEPTH[0]:
                    _count_kept()
        return call
    return wrap


def mark(kind: str, later=None, **attrs):
    """A context manager around one launch or one copy: the profiler range
    ``cdt#<kind> k=v ...`` while a profiler runs, a shared no-op
    otherwise.  ``later``: a 1-D device tensor whose positive entries the
    range ``cdt#counted`` reports under ``kind`` when the outermost spanned
    call returns (kept only inside one: outside, counting would add
    operations and a read to the launch)."""
    if not profiling():
        return _OFF
    if later is not None and _DEPTH[0]:
        _LATER.append((kind, later))
    return _range(MARK_PREFIX + kind
                  + "".join(f" {k}={v}" for k, v in attrs.items()))


def _count_kept():
    """Count the positive entries of the kept tensors, those of one shape
    in one concatenation (a profiler records each operation on a tensor:
    one a shape, not one a tensor), and open ``cdt#counted`` with the
    counts."""
    kept = _LATER[:]
    _LATER.clear()
    if not kept or not profiling():
        return
    shapes: dict = {}
    for i, (_, t) in enumerate(kept):
        shapes.setdefault((t.shape[0], t.dtype, t.device), []).append(i)
    count = [0] * len(kept)
    for (m, _, _), idx in shapes.items():
        flags = torch.cat([kept[i][1] for i in idx]).view(len(idx), m) > 0
        for i, c in zip(idx, torch.sum(flags, dim=1).tolist()):
            count[i] = c
    by_kind: dict = {}
    for (kind, _), c in zip(kept, count):
        by_kind.setdefault(kind, []).append(str(c))
    with _range(MARK_PREFIX + "counted" + "".join(
            f" {k}={','.join(v)}" for k, v in by_kind.items())):
        pass


def is_program_range(name: str) -> bool:
    """Whether a profiler event's name is one of :func:`span`'s or
    :func:`mark`'s ranges (the kernels' own ``cdt::`` names are not)."""
    return name.startswith(MARK_PREFIX) or (
        name.startswith(SPAN_PREFIX) and not name.startswith("cdt::"))
