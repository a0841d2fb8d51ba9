"""The readers of the port's own profiler ranges (``program_spans.py`` and
the metrics built on it), on synthetic traced problems: idle split at span
edges to the innermost span, idle under no span, marks owning none; None
from a trace with no port range; the K5 f64 roofline's count check; the
design-copy bytes."""

from __future__ import annotations

import pytest

from cdbench import program_spans, roofline
from cdbench.metrics import (design_copy_gib, engine_idle_ms,
                             k5f64_roofline, polish_idle_ms, refine_idle_ms)
from cdbench.trace import TracedProblem


def _tp(ops, host, start=0.0, end=100.0):
    return TracedProblem(ops=ops, spans=[("problem", start, end)], host=host,
                         start=start, end=end)


def _rec(*tps):
    return {"traced": [(tp, {}) for tp in tps]}


# device busy 0-10, 40-50, 90-100: idle 10-40 and 50-90 (70 µs)
OPS = [("k", 0.0, 10.0), ("k", 40.0, 50.0), ("k", 90.0, 100.0)]


def test_idle_goes_to_the_innermost_span_and_splits_at_edges():
    host = [("cdt:cd.solve", 0.0, 100.0),
            ("cdt:cd.full_check", 5.0, 30.0),       # nested in cd.solve
            ("cdt:cd.active_pass", 30.0, 60.0),     # a gap split 30 | 40
            ("cdt#design_copy bytes=8", 20.0, 25.0),  # a mark owns nothing
            ("aten::mm", 12.0, 14.0)]               # a host op, not a span
    owned, unowned = program_spans.idle_by_span(_tp(OPS, host))
    assert owned == {"cd.full_check": 20.0, "cd.active_pass": 20.0,
                     "cd.solve": 30.0}
    assert unowned == 0.0
    assert engine_idle_ms.read(_rec(_tp(OPS, host))) == pytest.approx(0.070)


def test_idle_under_no_span_and_the_sum():
    host = [("cdt:polish.lasso", 15.0, 35.0),
            ("cdt:polish.certify", 20.0, 25.0),
            ("cdt:path.refine_round", 60.0, 70.0),
            ("cdt:path.union_block_fista", 62.0, 64.0)]
    owned, unowned = program_spans.idle_by_span(_tp(OPS, host))
    assert owned == {"polish.lasso": 15.0, "polish.certify": 5.0,
                     "path.refine_round": 8.0, "path.union_block_fista": 2.0}
    # 10-15, 35-40, 50-60, 70-90
    assert unowned == 40.0
    assert sum(owned.values()) + unowned == 70.0
    rec = _rec(_tp(OPS, host))
    assert polish_idle_ms.read(rec) == pytest.approx(0.020)
    assert refine_idle_ms.read(rec) == pytest.approx(0.010)
    assert engine_idle_ms.read(rec) == 0.0


def test_averaged_over_the_traced_problems():
    a = _tp(OPS, [("cdt:vc.refine", 0.0, 100.0)])
    b = _tp(OPS, [("cdt:vc.refine_round", 0.0, 100.0)])
    assert refine_idle_ms.read(_rec(a, b)) == pytest.approx(0.070)


def test_none_without_the_ports_ranges():
    # an older port: its one range has no prefix; the kernels' own C++
    # namespace is no span either
    host = [("union_block_fista", 0.0, 50.0),
            ("cdt::sweep_kernel launch", 1.0, 2.0)]
    rec = _rec(_tp(OPS, host))
    for mod in (engine_idle_ms, refine_idle_ms, polish_idle_ms,
                design_copy_gib, k5f64_roofline):
        assert mod.read(rec) is None
    assert engine_idle_ms.read({"traced": []}) is None


def test_design_copy_gib_sums_the_marks_per_problem():
    a = _tp(OPS, [("cdt#design_copy bytes=1073741824", 1.0, 2.0),
                  ("cdt#design_copy bytes=536870912", 3.0, 4.0),
                  ("cdt:cd.build_blocked", 0.0, 5.0)])
    b = _tp(OPS, [("cdt:cd.solve", 0.0, 5.0)])
    assert design_copy_gib.read(_rec(a)) == pytest.approx(1.5)
    assert design_copy_gib.read(_rec(a, b)) == pytest.approx(0.75)


SWEEP = "void cdt::sweep_kernel<float, double>(float const*, double const*)"
REDUCE = "void cdt::sweep_reduce_kernel<double>(double const*, int)"


def test_k5f64_roofline_counts_and_time():
    m = {"n": 10_000, "p": 100_000, "x_item": 4}
    least = roofline.least_seconds(4 * 10_000 * 100_000 + 8 * 110_000,
                                   2 * 10_000 * 100_000)
    assert k5f64_roofline.least_seconds(m) == least
    mark = "cdt#k5f64 n=10000 p=100000 x_item=4"
    # 1,400 µs of sweep, then a reduction of 100 µs that follows it
    ops = [(SWEEP, 0.0, 1400.0), (REDUCE, 1400.0, 1500.0),
           ("void cdt::sweep_kernel<float, float>", 1600.0, 2000.0)]
    tp = _tp(ops, [(mark, 0.0, 1.0)], end=2000.0)
    got = k5f64_roofline.read(_rec(tp))
    assert got == pytest.approx(100.0 * least / 1.5e-3)
    # without the reduction: the sweep's time alone
    tp2 = _tp([(SWEEP, 0.0, 1400.0)], [(mark, 0.0, 1.0)], end=2000.0)
    assert k5f64_roofline.read(_rec(tp2)) == pytest.approx(
        100.0 * least / 1.4e-3)


def test_k5f64_roofline_none_when_marks_and_kernels_differ():
    mark = ("cdt#k5f64 n=10 p=20 x_item=4", 0.0, 1.0)
    two = _tp([(SWEEP, 0.0, 5.0), (SWEEP, 10.0, 15.0)], [mark])
    none = _tp([("k", 0.0, 5.0)], [mark])
    assert k5f64_roofline.read(_rec(two)) is None
    assert k5f64_roofline.read(_rec(none)) is None
    ok = _tp([(SWEEP, 0.0, 5.0)], [mark])
    assert k5f64_roofline.read(_rec(ok, two)) is None
    assert k5f64_roofline.read(_rec(ok)) > 0
