"""The p ≫ n benchmark cell ``p1m_path100`` (configuration
``lasso_p1m_n1000``: a 1,000 x 1,000,000 design), cut to a shape the CPU
runs in seconds, and what it reads of the port: the ``cdt#k1`` and
``cdt#union`` marks with the counts ``cdt#counted`` carries,
``k1_roofline`` and ``union_fill``.

The cut keeps p ≫ n (n = 200, p = 16,384: p / n = 82) with the cell's
traffic (the 100-point grid, the batched execution, the options) and
shrinks the pool and the sample, as ``cdbench/tests/tiny.py`` shrinks the
other cells.
"""

from __future__ import annotations

import contextlib
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import coordinatedescent_jl_tpu_torch as tcd  # noqa: E402
from coordinatedescent_jl_tpu_torch.kernels import (  # noqa: E402
    _build, active_pass)
from coordinatedescent_jl_tpu_torch.ops import block_cd  # noqa: E402
from coordinatedescent_jl_tpu_torch.utils import host  # noqa: E402

from cdbench import counted, run  # noqa: E402
from cdbench.metrics import k1_roofline, union_fill  # noqa: E402
from cdbench.reference import lasso_path as path_reference  # noqa: E402
from cdbench.reference import lasso_path_wide, solvers  # noqa: E402
from cdbench.tasks import lasso_path_wide as wide_task  # noqa: E402
from cdbench.tests.test_cdbench_harness import (  # noqa: E402
    _altered, _half_left_out, _unchanged)
from cdbench.trace import TracedProblem  # noqa: E402

CELL = "p1m_path100"
SEED = 20_261_018_019
CUT = {"n": 200, "p": 16_384}


def _cut():
    """``(cell, cfg, traffic)`` of ``p1m_path100`` cut for the CPU."""
    cell, cfg, traffic = run.resolve(run.load_spec(), CELL)
    cfg = {**cfg, **CUT}
    traffic = {**traffic, "pool": 4, "planted": 10,
               "check": {**traffic["check"], "span": 2, "problems": 1}}
    return cell, cfg, traffic


def test_cell_names_the_wide_task_and_a_whole_design():
    cell, cfg, traffic = run.resolve(run.load_spec(), CELL)
    assert (cfg["n"], cfg["p"], cfg["dtype"]) == (1000, 1_000_000, "float32")
    assert cfg["design_bytes"] == cfg["n"] * cfg["p"] * 4
    assert cell["chips"] == 1 and cell["config"] == "lasso_p1m_n1000"
    assert traffic["task"] == "lasso_path_wide"
    assert (traffic["points"], traffic["path_batch"],
            traffic["coarse_stride"]) == (100, 128, 99)
    # the task drives the port exactly as the lasso_path task does
    from cdbench.tasks import lasso_path
    assert wide_task.solve is lasso_path.solve
    assert wide_task.prepare is lasso_path.prepare


def test_cut_cell_runs_correct_and_certified():
    """(i) The cut cell through the harness on the CPU: every problem
    certified by the batched certificate (a scan fallback is uncertified)
    and within the traffic's limit of the float64 reference."""
    cell, cfg, traffic = _cut()
    rec = run.run_cell(cell, cfg, traffic, SEED, 0.0, False,
                       torch.device("cpu"), time.perf_counter())
    assert rec["problems"] and all(p.certified for p in rec["problems"])
    assert all(p.counts["refine_rounds"] >= 1 for p in rec["problems"])
    assert rec["checks"]["uncertified"]["value"] == 0
    assert rec["checks"]["coef_err"]["value"] <= traffic["limits"]["coef_err"]
    assert rec["correct"]


@pytest.mark.parametrize("fault", ["unchanged", "altered", "half_left_out"])
def test_cut_cell_with_a_broken_timed_path_is_not_correct(monkeypatch,
                                                          fault):
    """The cut cell's judge (``reference/lasso_path_wide.py``) turns a
    broken path into ``correct: false``: the path left at its start
    (zeros), its largest coefficient 1 % off, or every second λ point left
    out and filled from its neighbours (the faults the harness's tests
    plant in the other cells)."""
    make = {"unchanged": _unchanged, "altered": _altered,
            "half_left_out": _half_left_out}[fault]
    monkeypatch.setattr(tcd, "lasso_path", make("lasso_path"))
    cell, cfg, traffic = _cut()
    rec = run.run_cell(cell, cfg, traffic, SEED, 0.0, False,
                       torch.device("cpu"), time.perf_counter())
    assert not rec["correct"], rec["checks"]
    assert rec["failed"] >= 1


def test_batched_path_float64_agrees_with_the_reference():
    """(ii) The port's batched path in float64, with the cell's options, at
    the cut size against the plain reference at the points a run judges.
    The batched certificate bounds every coordinate's prox step by opt_tol
    = 1e-6; on this cut the support (about 20 of 200 rows) has a
    well-conditioned Gram, so no coefficient lies further than ~opt_tol
    from the optimum, against max |b*| near 1, and float64 rounding adds
    ~1e-13: the tolerance is opt_tol itself, relative to max |b*|
    (measured 6.0e-8 at this seed)."""
    _, cfg, traffic = _cut()
    cfg = {**cfg, "dtype": "float64"}
    state = wide_task.prepare(cfg, traffic, SEED, torch.device("cpu"))
    st = {}
    path = tcd.lasso_path(state.X, state.Y[0], state.lams[0],
                          options=state.opts, standardize_X=False,
                          path_batch=traffic["path_batch"],
                          coarse_stride=traffic["coarse_stride"], stats=st,
                          device="cpu")
    assert st["used_batched"] and st["batched_certified"]
    assert st["refine_rounds"] >= 1
    judged = lasso_path_wide.judge(state, {0: (0, path.beta_path)})
    assert judged[0]["coef_err"] <= traffic["options"]["opt_tol"]
    # the smallest λ is judged, and its support holds more columns than
    # were planted: noise columns enter, as at p >> n they do
    last = state.lams.shape[1] - 1
    assert last in path_reference.points(state, 0)
    assert int(torch.sum(path.beta_path[last] != 0)) > traffic["planted"]


def test_wide_reference_meets_the_optimality_conditions():
    """The wide reference at the smallest λ of a cut design with 40
    planted columns, from a cold start, where the support passes n/2 (the
    regime in which ``solvers.lasso``'s working set outgrows n): |X'r| =
    nλ on the support with the coefficients' signs and |X'r| <= nλ off
    it, in float64."""
    _, cfg, traffic = _cut()
    state = wide_task.prepare(cfg, {**traffic, "planted": 40}, SEED,
                              torch.device("cpu"))
    lam = float(state.lams[1, -1])
    b, ok = lasso_path_wide.lasso(state.X, state.Y[1], lam)
    assert ok
    n = state.X.shape[0]
    g = solvers.xtr(state.X, state.Y[1].double()
                    - state.X.double() @ b) / (n * lam)
    sup = b != 0
    assert n // 2 < int(sup.sum()) < n
    assert float(torch.amax(torch.abs(g[sup] - torch.sign(b[sup])))) < 1e-9
    assert float(torch.amax(torch.abs(g[~sup]))) <= 1 + 1e-9


# ---------------------------------------------------------------------------
# (iii) The marks, and the metrics that read them
# ---------------------------------------------------------------------------


@pytest.fixture
def recorded(monkeypatch):
    """``recorded(fn)``: ``fn()`` with the profiler's flag raised and the
    range openers recording; its result and the names of the ranges
    opened, in order."""
    def go(fn):
        names = []

        @contextlib.contextmanager
        def record_function(name):
            names.append(name)
            yield

        with monkeypatch.context() as m:
            m.setattr(host, "profiling", lambda: True)
            m.setattr(torch.profiler, "record_function", record_function)
            m.setattr(torch._C._profiler, "_RecordFunctionFast",
                      record_function)
            out = fn()
        return out, names

    return go


@pytest.fixture
def no_ranges(monkeypatch):
    """Range openers that raise: a test under it passes only if nothing
    opens a range (as without a profiler)."""
    def boom(name):
        raise AssertionError(f"a range was opened without a profiler: "
                             f"{name}")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", boom)


def _marks(names, kind):
    out = []
    for name in names:
        head, *pairs = name.split(" ")
        if head == host.MARK_PREFIX + kind:
            out.append({k: int(v) for k, v in (q.split("=") for q in pairs)})
    return out


def _counts(names, kind):
    """What the ``cdt#counted`` ranges among ``names`` carry for ``kind``."""
    return counted.counts(_tp([], [(name, float(i), float(i))
                                   for i, name in enumerate(names)]), kind)


@pytest.fixture
def fake_k1(monkeypatch):
    """The K1 wrapper's launch path on the CPU: a library whose entry
    point only counts its calls, and the inputs of a pass over 3 blocks of
    which 2 are active, on the cluster route's plan."""
    calls = []
    lib = types.SimpleNamespace(
        cdt_active_pass_f32=lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda dev=None: 0)
    g = torch.Generator().manual_seed(3)
    X = torch.randn((40, 3 * 128), generator=g)
    y = torch.randn((40,), generator=g)
    opts = tcd.CDOptions(block_size=128, cache_gram=True)
    prob = block_cd.build_blocked("ls", opts, torch.ones(3 * 128), X=X, y=y)
    st = block_cd._init_state("ls", prob, torch.zeros((3, 128)), None)
    plan = active_pass.plan_active_pass(40, 128, 4, 132)
    act = torch.tensor([True, False, True])
    args = (prob, st.beta, st.r, act, 0.1, 40.0, torch.arange(3),
            torch.arange(128), "ls", st.rsqr, "ista", 16, plan)
    return (lambda: active_pass._fused_active_pass_cuda(*args)), calls, plan


def test_k1_mark_only_under_a_profiler(fake_k1, recorded, no_ranges):
    launch, calls, _ = fake_k1
    launch()                          # no_ranges: any range would raise
    reads = host.COUNTS["host_reads"]
    _, names = recorded(launch)
    assert len(calls) == 2
    # outside any entry point the mark keeps nothing: no count, no read
    assert names == ["cdt#k1 n=40 B=128 iters=16 gram=1 x_item=4"]
    assert host.COUNTS["host_reads"] == reads


def test_k1_blocks_counted_after_the_entry_point(fake_k1, recorded):
    """Inside a spanned call the launch reads nothing: the kept masks are
    counted, in launch order, once the outermost call has returned."""
    launch, calls, _ = fake_k1
    seen = []

    @host.spanned("test.outer")
    def outer():
        inner()
        seen.append(list(host._LATER))

    @host.spanned("test.inner")
    def inner():
        launch()
        launch()

    _, names = recorded(outer)
    assert len(calls) == 2 and len(seen[0]) == 2
    assert names == ["cdt:test.outer", "cdt:test.inner",
                     "cdt#k1 n=40 B=128 iters=16 gram=1 x_item=4",
                     "cdt#k1 n=40 B=128 iters=16 gram=1 x_item=4",
                     "cdt#counted k1=2,2"]
    assert host._LATER == [] and host._DEPTH == [0]


def _path_problem():
    rng = np.random.default_rng(11)
    n, p = 60, 2048
    X = rng.standard_normal((n, p))
    b = np.zeros(p)
    b[rng.choice(p, 5, replace=False)] = rng.standard_normal(5)
    y = X @ b + 0.3 * rng.standard_normal(n)
    lams = float(np.abs(X.T @ y).max() / n) * np.logspace(-0.3, -1.0, 12)
    return torch.as_tensor(X), torch.as_tensor(y), lams


def _path(stats):
    X, y, lams = _path_problem()
    opts = tcd.CDOptions(opt_tol=1e-9, randomize=False, block_size=64,
                         compact_size=256)
    return tcd.lasso_path(X, y, lams, options=opts, standardize_X=False,
                          path_batch=6, coarse_stride=11, stats=stats,
                          device="cpu").beta_path


def test_union_marks_one_a_round_only_under_a_profiler(recorded, no_ranges):
    quiet = {}
    off = _path(quiet)                # no_ranges: any range would raise
    st = {}
    on, names = recorded(lambda: _path(st))
    assert torch.equal(on, off)
    assert quiet == st and st["batched_certified"]
    ms = _marks(names, "union")
    need = _counts(names, "union")
    assert len(ms) == len(need) == st["refine_rounds"] >= 1
    assert all(m == {"cap": 256} for m in ms)
    assert all(0 < c <= 2048 for c in need)
    # counted once, after the path's range has closed
    assert [n for n in names if n.startswith("cdt#counted")] == [names[-1]]
    # the engine's passes on the CPU take the plain twin: no K1 launch
    assert _marks(names, "k1") == [] and _counts(names, "k1") == []


def test_k1_counts_match_chip_smokes_row():
    """The K1_n1000 row of chip_smoke.py: 8 blocks at n = 1,000, Grams
    cached, 16 FISTA steps."""
    assert k1_roofline.k1_bytes(8, 1000) == 4 * (8 * 1000 * 128
                                              + 8 * 128 * 128
                                              + 3 * 8 * 128 + 2 * 1000)
    assert k1_roofline.k1_bytes(8, 1000) == 4_640_576
    assert k1_roofline.k1_flops(8, 1000) == 8 * (4 * 1000 * 128
                                              + 16 * 2 * 128 * 128)
    # without a cached Gram: no Gram read, X_b'X_b computed (2 n B² a block)
    assert k1_roofline.k1_bytes(8, 1000, gram=False) == 4 * (
        8 * 1000 * 128 + 3 * 8 * 128 + 2 * 1000)
    assert k1_roofline.k1_flops(8, 1000, gram=False) == 8 * (
        4 * 1000 * 128 + 16 * 2 * 128 * 128 + 2 * 1000 * 128 * 128)
    # float64 items (the polishes' inner solve); the exact scan's flops
    assert k1_roofline.k1_bytes(1, 10, 4, 8) == 8 * (10 * 4 + 16 + 12 + 20)
    assert k1_roofline.k1_flops(2, 10, 4, 0) == 2 * (160 + 32 + 160)


def _tp(ops, host_events):
    return TracedProblem(ops=ops, spans=[("problem", 0.0, 100.0)],
                         host=host_events, start=0.0, end=100.0)


def _rec(*tps):
    return {"traced": [(tp, {}) for tp in tps]}


K1_NAME = ("void cdt::active_pass_kernel<float, 0, true>(float const*, "
           "float const*)")
MARK = "cdt#k1 n=1000 B=128 iters=16 gram=1 x_item=4"


def test_k1_roofline_counts_the_visited_blocks_and_device_time():
    ops = [(K1_NAME, 0.0, 100.0), ("void other_kernel", 100.0, 150.0),
           (K1_NAME, 200.0, 300.0)]
    # the counts in launch order, in the one range that follows the marks
    rec = _rec(_tp(ops, [(MARK, 0.0, 1.0), (MARK, 150.0, 151.0),
                         ("cdt#counted k1=8,1", 400.0, 400.5)]))
    least = (max(4_640_576 / 3.35e12, 8_290_304 / 67e12)
             + max(k1_roofline.k1_bytes(1, 1000) / 3.35e12,
                   k1_roofline.k1_flops(1, 1000) / 67e12))
    assert k1_roofline.read(rec) == pytest.approx(100.0 * least / 200e-6)
    # the same trace with its host events out of time order
    tp = rec["traced"][0][0]
    back = _rec(tp._replace(host=tp.host[::-1]))
    assert k1_roofline.read(back) == pytest.approx(k1_roofline.read(rec))


def test_k1_roofline_none_when_marks_and_kernels_differ():
    ops = [(K1_NAME, 0.0, 100.0), (K1_NAME, 200.0, 300.0)]
    assert k1_roofline.read(_rec(_tp(ops, [
        (MARK, 0.0, 1.0), ("cdt#counted k1=8", 400.0, 400.5)]))) is None
    # marks without their counts, or counts without their marks
    assert k1_roofline.read(_rec(_tp(ops, [
        (MARK, 0.0, 1.0), (MARK, 2.0, 3.0)]))) is None
    assert k1_roofline.read(_rec(_tp(ops, [
        (MARK, 0.0, 1.0), (MARK, 2.0, 3.0),
        ("cdt#counted k1=8", 400.0, 400.5)]))) is None
    # a tree that opens no mark (the parent of this metric)
    assert k1_roofline.read(_rec(_tp(ops, []))) is None
    assert k1_roofline.read(_rec(_tp([], []))) is None


def test_union_fill_sums_need_over_capacity():
    a = _tp([], [("cdt#union cap=1024", 0.0, 1.0),
                 ("cdt#union cap=1024", 2.0, 3.0),
                 ("cdt#counted union=300,900", 5.0, 6.0)])
    # two entry points in one problem: two ranges of counts, in time order
    b = _tp([], [("cdt#union cap=1024", 0.0, 1.0),
                 ("cdt#k1 n=1 B=1 iters=1 gram=1 x_item=4", 1.0, 2.0),
                 ("cdt#counted k1=1 union=1500", 3.0, 4.0),
                 ("cdt#union cap=1024", 5.0, 6.0),
                 ("cdt#counted union=500", 7.0, 8.0)])
    assert union_fill.read(_rec(a, b)) == pytest.approx(
        100.0 * 3200 / 4096)
    assert union_fill.read(_rec(_tp([], []))) is None
    # a mark without its count
    c = _tp([], [("cdt#union cap=1024", 0.0, 1.0)])
    assert union_fill.read(_rec(a, c)) is None


def test_metrics_read_none_from_an_untraced_record():
    assert k1_roofline.read({"traced": []}) is None
    assert union_fill.read({"traced": []}) is None
