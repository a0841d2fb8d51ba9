"""The port's profiler spans and marks (``utils/host.py``), on the CPU at
tiny shapes: with no profiler running nothing is recorded (patched range
openers that raise are never reached); while one runs the
engine's epoch spans count the epochs, the refine-round spans count the
rounds the entry points report, the design-copy marks carry the bytes of
the copies, the K5 f64 mark its shape; the outputs are the same bit for
bit with the profiler on and off.

The counts are read through a recording range opener with the profiler's
flag raised (``recorded``): the CPU profiler records every
aten operation, and reading back a path's ~600,000 events takes it most
of a minute.  A real profiler session checks that the ranges reach its
record under the same names (``test_real_profiler_records_the_ranges``).
"""

import contextlib
import ctypes
import itertools
import re
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.profiler import ProfilerActivity, profile  # noqa: E402

import coordinatedescent_jl_tpu_torch as tcd  # noqa: E402
from coordinatedescent_jl_tpu_torch.kernels import (  # noqa: E402
    gradient_sweep)
from coordinatedescent_jl_tpu_torch.ops import block_cd, group_cd  # noqa: E402
from coordinatedescent_jl_tpu_torch.utils import host  # noqa: E402

CPU = {"device": "cpu"}
OPTS = tcd.CDOptions(opt_tol=1e-8, randomize=False, block_size=32)


def _problem(n, p, s, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p))
    b = np.zeros(p)
    b[rng.choice(p, s, replace=False)] = rng.standard_normal(s)
    y = X @ b + 0.3 * rng.standard_normal(n)
    return (torch.as_tensor(X.astype(dtype)),
            torch.as_tensor(y.astype(dtype)))


def _lam_max(X, y):
    return float(torch.max(torch.abs(X.T @ y)) / X.shape[0])


def _lasso_polish():
    X, y = _problem(80, 200, 5, 1)
    lam = 0.1 * _lam_max(X, y)
    sol = tcd.lasso(X, y, lam, options=OPTS, **CPU)
    res = tcd.polish_lasso(X, y, sol.x, lam, **CPU)
    return sol.x, res.beta


def _path(stats=None):
    X, y = _problem(150, 300, 6, 23)
    lams = _lam_max(X, y) * np.logspace(-0.1, -1.5, 13)
    opts = tcd.CDOptions(opt_tol=1e-10, randomize=False, block_size=32)
    return (tcd.lasso_path(X, y, lams, options=opts, standardize_X=False,
                           path_batch=4, coarse_stride=4, stats=stats,
                           **CPU).beta_path,)


def _group():
    X, y = _problem(80, 160, 8, 3)
    lam = 0.2 * _lam_max(X, y)
    sol = tcd.group_lasso(X, y, lam, 4, options=OPTS, **CPU)
    res = tcd.polish_group_lasso(X, y, sol.x, lam, 4, **CPU)
    return sol.x, res.beta


def _vc(stats=None):
    rng = np.random.default_rng(7)
    n, p = 100, 6
    X = rng.standard_normal((n, p))
    z = rng.uniform(size=n)
    y = np.sin(2 * np.pi * z) * X[:, 0] + 0.3 * rng.standard_normal(n)
    opts = tcd.CDOptions(opt_tol=1e-10, block_size=16, randomize=False)
    return tcd.locpolyl1(X, z, y, np.linspace(0.05, 0.95, 20), 1,
                         tcd.GaussianKernel(0.1), 0.05, options=opts,
                         grid_batch=8, coarse_stride=7, stats=stats, **CPU)


ENTRIES = {"lasso_polish": _lasso_polish, "path": _path, "group": _group,
           "locpolyl1": _vc}


@pytest.fixture
def recorded(monkeypatch):
    """``recorded(fn, *args)``: ``fn(*args)`` with the profiler's flag
    raised and the range openers recording; its result and the ranges
    opened, ``[name, start, end]`` on a counter's clock, in start order."""
    def run(fn, *args):
        clock = itertools.count()
        ranges = []

        @contextlib.contextmanager
        def record_function(name):
            r = [name, next(clock), None]
            ranges.append(r)
            try:
                yield
            finally:
                r[2] = next(clock)

        with monkeypatch.context() as m:
            m.setattr(host, "profiling", lambda: True)
            m.setattr(torch.profiler, "record_function", record_function)
            m.setattr(torch._C._profiler, "_RecordFunctionFast",
                      record_function)
            out = fn(*args)
        assert all(r[2] is not None for r in ranges)
        return out, ranges

    return run


def _count(ranges, *names):
    return sum(1 for r in ranges
               if r[0] in {host.SPAN_PREFIX + n for n in names})


def _marks(ranges, kind):
    """The attributes of each ``kind`` mark, as ints."""
    out = []
    for name, _, _ in ranges:
        head, *pairs = name.split(" ")
        if head == host.MARK_PREFIX + kind:
            out.append({k: int(v) for k, v in (q.split("=") for q in pairs)})
    return out


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_nothing_recorded_without_a_profiler(entry, monkeypatch):
    """No profiler: the spans and marks never open a range (a
    ``record_function``, nor its light form, that raise are never
    called)."""
    def boom(*a, **k):
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", boom)
    assert not host.profiling()
    ENTRIES[entry]()


def test_span_and_mark_are_shared_no_ops_when_off():
    assert host.span("cd.full_check") is host.span("vc.refine")
    assert host.mark("design_copy", bytes=1) is host.span("x")
    with profile(activities=[ProfilerActivity.CPU]):
        assert host.profiling()
        assert host.span("a") is not host.span("a")
    assert host.is_program_range("cdt:cd.full_check")
    assert host.is_program_range("cdt#k5f64 n=1 p=2 x_item=4")
    assert not host.is_program_range("void cdt::sweep_kernel<float, double>")
    assert not host.is_program_range("cdbench:problem")


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_outputs_bit_identical_with_profiler_on_and_off(entry):
    off = ENTRIES[entry]()
    with profile(activities=[ProfilerActivity.CPU]):
        on = ENTRIES[entry]()
    for a, b in zip(off, on, strict=True):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def test_real_profiler_records_the_ranges(recorded):
    """A CPU profiler session holds the same ranges, by name and count, as
    the recording stand-in, nested the same way."""
    _, want = recorded(_group)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _group()
    got = sorted(((e.name, e.time_range.start, e.time_range.end)
                  for e in prof.events() if host.is_program_range(e.name)),
                 key=lambda r: r[1])
    assert [r[0] for r in got] == [r[0] for r in want]
    assert {"cdt:group.build", "cdt:group.solve", "cdt:polish.group_lasso",
            "cdt:polish.certify"} <= {r[0] for r in got}
    for ranges in (got, want):
        (whole,) = [r for r in ranges if r[0] == "cdt:polish.group_lasso"]
        assert _count(ranges, "polish.certify") >= 1
        assert all(_inside(r, whole) for r in ranges
                   if r[0].startswith("cdt:polish."))


ENGINE = ("cd.full_check", "cd.compact_pass", "cd.active_pass",
          "group.full_check", "group.active_pass")


@pytest.mark.parametrize("case", ["lasso", "lasso_compact", "wls", "sqrt",
                                  "group", "path", "locpolyl1"])
def test_engine_epoch_spans_count_the_epochs(case, recorded):
    """One ``cd.*`` / ``group.*`` arm span an epoch
    (``host.COUNTS["epochs"]``), the compaction's inner solves included."""
    X, y = _problem(120, 512, 6, 5)
    lam = 0.1 * _lam_max(X, y)
    runs = {
        "lasso": lambda: tcd.lasso(X, y, lam, options=OPTS, **CPU),
        "lasso_compact": lambda: tcd.lasso(
            X, y, lam, options=OPTS.replace(compact=True, compact_size=64),
            **CPU),
        "wls": lambda: tcd.coordinate_descent(
            torch.zeros(512, dtype=X.dtype),
            tcd.WeightedLSLoss(y, X, torch.linspace(0.5, 1.5, 120,
                                                    dtype=X.dtype)),
            tcd.ProxL1(lam), OPTS, **CPU),
        "sqrt": lambda: tcd.sqrt_lasso(X, y, 3.0, options=OPTS, **CPU),
        "group": lambda: tcd.group_lasso(X, y, 2 * lam, 4, options=OPTS,
                                         **CPU),
        "path": _path,
        "locpolyl1": _vc,
    }
    e0 = host.COUNTS["epochs"]
    _, ranges = recorded(runs[case])
    epochs = host.COUNTS["epochs"] - e0
    assert epochs > 0
    assert _count(ranges, *ENGINE) == epochs
    if case == "lasso_compact":
        assert _count(ranges, "cd.compact_pass") > 0


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_path_refine_round_spans_count_the_rounds(recorded):
    st = {}
    _, ranges = recorded(_path, st)
    rounds = [r for r in ranges if r[0] == "cdt:path.refine_round"]
    fista = [r for r in ranges if r[0] == "cdt:path.union_block_fista"]
    assert st["refine_rounds"] >= 1
    assert len(rounds) == len(fista) == st["refine_rounds"]
    assert all(any(_inside(f, r) for r in rounds) for f in fista)
    chunks = [r for r in ranges if r[0] == "cdt:path.refine"]
    assert chunks and all(any(_inside(r, c) for c in chunks) for r in rounds)
    (entry,) = [r for r in ranges if r[0] == "cdt:est.lasso_path"]
    (batched,) = [r for r in ranges if r[0] == "cdt:path.batched"]
    (scan,) = [r for r in ranges if r[0] == "cdt:path.coarse_scan"]
    assert _inside(scan, batched) and _inside(batched, entry)
    assert ranges[0] == entry


def test_vc_refine_round_spans_count_the_rounds(recorded):
    """``stats["refine_rounds"]`` of ``locpolyl1``: the rounds of every
    chunk's ``_VcBatchOps.solve``, one ``vc.refine_round`` span each."""
    st = {}
    _, ranges = recorded(_vc, st)
    assert st["used_batched"] and st["batched_certified"]
    assert st["refine_rounds"] >= 1
    assert _count(ranges, "vc.refine_round") == st["refine_rounds"]
    assert _count(ranges, "vc.refine") == 2       # 16 lanes, chunks of 8
    for name in ("vc.batched", "vc.anchors", "vc.refit"):
        assert _count(ranges, name) == 1


@pytest.fixture
def fake_vc_round(monkeypatch):
    """The varying-coefficient round's launch path on the CPU: the mode
    rule takes the kernel, and the library's entry point writes what the
    plain twin computes for that round into the launch's output buffers
    (``B, R, mx, cert, best, stall, esc``, its 17th to 23rd arguments).
    Returns the entry point's calls."""
    from coordinatedescent_jl_tpu_torch.kernels import _build, vc_round
    from coordinatedescent_jl_tpu_torch.models import varying_coefficient

    calls, pending = [], []

    def entry(*args):
        calls.append(args)
        for ptr, t in zip(args[16:23], pending.pop()):
            t = t.contiguous()
            ctypes.memmove(ptr, t.data_ptr(), t.numel() * t.element_size())
        return 0

    def launch(ops, *state):
        pending.append(ops.round_plain(*state))
        return vc_round._launch(ops, *state)

    lib = types.SimpleNamespace(cdt_vc_round_f32=entry,
                                cdt_vc_round_f64=entry)
    monkeypatch.setattr(varying_coefficient, "use_kernels", lambda o, t: True)
    monkeypatch.setattr(vc_round, "fused_vc_round", launch)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda dev=None: 0)
    monkeypatch.setattr(_build, "smem_optin", lambda dev: 232_448)
    return calls


def test_vc_round_mark_one_a_launch_counted_later(recorded, fake_vc_round):
    """A ``cdt#vc_round`` mark around each launch of the round's kernel,
    one a refine round inside its ``vc.refine_round`` span, with the
    launch's shape and route; the live lanes of each are counted once the
    entry point has returned (``cdt#counted vc_round=``), and that count
    adds no host read: the counted reads, the stats and the output are
    those of the run without a profiler."""
    from coordinatedescent_jl_tpu_torch.kernels import vc_round

    quiet = {}
    r0 = host.COUNTS["host_reads"]
    off = _vc(quiet)
    reads_off = host.COUNTS["host_reads"] - r0
    n_off = len(fake_vc_round)
    st = {}
    l0 = vc_round.LAUNCHES
    on, ranges = recorded(_vc, st)
    assert host.COUNTS["host_reads"] - r0 - reads_off == reads_off
    assert quiet == st and st["batched_certified"]
    assert all(torch.equal(a, b) for a, b in zip(on, off, strict=True))
    rounds = [r for r in ranges if r[0] == "cdt:vc.refine_round"]
    marks = [r for r in ranges if r[0].startswith("cdt#vc_round ")]
    assert len(marks) == len(rounds) == st["refine_rounds"] == n_off >= 2
    assert vc_round.LAUNCHES - l0 == st["refine_rounds"]
    assert all(any(_inside(m, r) for r in rounds) for m in marks)
    # 16 lanes in two chunks of 8; float64, route 0 (X in shared memory)
    assert _marks(ranges, "vc_round") == [
        {"k": 8, "n": 100, "p": 6, "q1": 2, "iters": 16, "x_item": 8,
         "route": 0}] * len(marks)
    (counted,) = [r for r in ranges if r[0].startswith("cdt#counted")]
    assert counted is ranges[-1]
    head, pair = counted[0].split(" ")
    kind, live = pair.split("=")
    live = [int(c) for c in live.split(",")]
    assert kind == "vc_round" and len(live) == len(marks)
    assert all(1 <= c <= 8 for c in live)


def test_polish_spans(recorded):
    """Each polish round: one restricted solve, one certificate (a
    ``grad_f64`` sweep, marked with its shape), inside the polish's span."""
    X, y = _problem(80, 200, 5, 1)
    lam = 0.1 * _lam_max(X, y)
    x0 = tcd.lasso(X, y, lam, options=OPTS, **CPU).x.to(torch.float32)
    res, ranges = recorded(
        lambda: tcd.polish_lasso(X.to(torch.float32), y, x0, lam, **CPU))
    (whole,) = [r for r in ranges if r[0] == "cdt:polish.lasso"]
    certs = [r for r in ranges if r[0] == "cdt:polish.certify"]
    assert len(certs) == res.rounds >= 1
    assert _count(ranges, "polish.restricted_solve") == res.rounds
    assert all(_inside(r, whole) for r in ranges)
    assert _marks(ranges, "k5f64") == [{"n": 80, "p": 200,
                                        "x_item": 4}] * res.rounds


def test_k5f64_mark_on_grad_f64(recorded):
    X = torch.randn(30, 70, dtype=torch.float64)
    r = torch.randn(30, dtype=torch.float64)
    g, ranges = recorded(gradient_sweep.grad_f64, X, r)
    assert torch.equal(g, gradient_sweep.grad_f64(X, r))
    assert _marks(ranges, "k5f64") == [{"n": 30, "p": 70, "x_item": 8}]


def _copies(recorded, fn):
    """The bytes of the ``design_copy`` marks under ``fn``, and its
    result."""
    out, ranges = recorded(fn)
    return [m["bytes"] for m in _marks(ranges, "design_copy")], out


@pytest.mark.parametrize("case", ["ls_padded", "ls_whole_blocks",
                                  "wls_padded", "one_block", "group"])
def test_design_copy_marks_carry_the_bytes(case, recorded):
    """A padding (only when it pads), a blockify (only when it copies) and
    the weighted ``X·w`` are each marked with the bytes they write."""
    p = {"ls_whole_blocks": 256, "one_block": 20}.get(case, 250)
    X = torch.randn(40, p)
    y = torch.randn(40)
    w = torch.rand(40) + 0.5
    opts = tcd.CDOptions(block_size=32)
    lamw = torch.ones(p)
    if case == "group":
        got, prob = _copies(recorded, lambda: (
            group_cd._build_group_problem(X, y, torch.ones(-(-p // 8)), 8,
                                          w)))
    else:
        kind = "wls" if case.startswith("wls") else "ls"
        got, prob = _copies(recorded, lambda: block_cd.build_blocked(
            kind, opts, lamw, X=X, y=y, w=w if kind == "wls" else None))
    nbytes = prob.Xb.numel() * prob.Xb.element_size()
    padded = 40 * (-(-p // prob.Xb.shape[2]) * prob.Xb.shape[2]) * 4
    want = {"ls_padded": [padded, nbytes],
            "ls_whole_blocks": [nbytes],
            "wls_padded": [padded, nbytes, padded, nbytes],
            "one_block": [padded],
            "group": [padded, nbytes, padded, nbytes]}[case]
    assert got == want
    if case == "one_block":
        assert prob.Xb.shape[0] == 1


def test_mark_name_carries_its_attributes():
    """The mark's name carries its attributes in order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with host.mark("k5f64", n=3, p=4, x_item=8):
            torch.ones(1)
    names = [e.name for e in prof.events() if host.is_program_range(e.name)]
    assert names == ["cdt#k5f64 n=3 p=4 x_item=8"]
    assert re.fullmatch(r"cdt#\w+( \w+=\d+)*", names[0])
