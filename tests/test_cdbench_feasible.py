"""The heteroscedastic benchmark cell ``feasible_hetero`` (configuration
``lasso_hetero_10kx100k``: the feasible Lasso and its float64 polish on a
10,000 x 100,000 design), cut to a shape the CPU runs in seconds, and what
it reads of the port: the ``feasible.round`` / ``polish.loading_round``
spans, the ``cdt#loadings`` marks inside the ``feasible.loadings`` /
``polish.loadings`` spans, ``loadings_roofline`` and
``loading_rounds_per_problem``.

The cut keeps the cell's traffic (λ0 = sqrt(2 ln p / n) at the cut's own
shape, the outer and inner options, the polish's targets) at n = 300, p =
2,000 and s = 5, and shrinks the pool and the sample, as
``tests/test_cdbench_p1m.py`` shrinks its cell.  ``solve_err`` carries
the outer loop's 1e-2 stopping rule: the float32 stage's coefficients
are solved one loading update before the loadings it returns, and how far
that moves them grows with λ0, which is 4.7 times the cell's at the cut;
the cut's ``solve_err`` limit is the cell's scaled by that ratio.
"""

from __future__ import annotations

import math
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import coordinatedescent_jl_tpu_torch as tcd  # noqa: E402
from coordinatedescent_jl_tpu_torch.models import lasso, polish  # noqa: E402

from cdbench import data, run  # noqa: E402
from cdbench.metrics import (loading_rounds_per_problem,  # noqa: E402
                             loadings_roofline)
from cdbench.reference import feasible_lasso as reference  # noqa: E402
from cdbench.reference import solvers  # noqa: E402
from cdbench.tasks import feasible_lasso as task  # noqa: E402
from cdbench.trace import TracedProblem  # noqa: E402

CELL = "feasible_hetero"
SEEDS = (20_261_018_023, 3_141_592_653)
CUT = {"n": 300, "p": 2000, "planted": 5}
CPU = torch.device("cpu")


def _cut():
    """``(cell, cfg, traffic)`` of ``feasible_hetero`` cut for the CPU."""
    cell, cfg, traffic = run.resolve(run.load_spec(), CELL)
    scale = task.lam0_of(CUT["n"], CUT["p"]) / task.lam0_of(cfg["n"],
                                                             cfg["p"])
    limits = {**traffic["limits"],
              "solve_err": traffic["limits"]["solve_err"] * scale}
    traffic = {**traffic, "pool": 4, "limits": limits,
               "check": {**traffic["check"], "span": 2, "problems": 1}}
    cfg = {**cfg, **CUT}
    return cell, cfg, traffic


def _run(seed=SEEDS[0]):
    cell, cfg, traffic = _cut()
    return run.run_cell(cell, cfg, traffic, seed, 0.0, False, CPU,
                        time.perf_counter()), traffic


def test_cell_names_its_configuration_task_one_chip_and_a_whole_design():
    cell, cfg, traffic = run.resolve(run.load_spec(), CELL)
    assert cell["chips"] == 1 and cell["config"] == "lasso_hetero_10kx100k"
    assert traffic["task"] == "feasible_lasso"
    assert (cfg["n"], cfg["p"], cfg["dtype"], cfg["tf32"]) == (
        10_000, 100_000, "float32", False)
    assert cfg["design_bytes"] == cfg["n"] * cfg["p"] * 4
    assert cfg["reduced"] == [] and cfg["planted"] == 100
    spec = {c["name"]: c for c in run.load_spec()["configs"]}
    assert spec[cell["config"]]["reduced"] == []
    # upstream IterLassoOptions' defaults outside, the other cells' inside
    assert traffic["outer"] == {"max_iter": 20, "opt_tol": 1e-2,
                                "init_procedure": "screening", "s_init": 5}
    assert traffic["options"] == {"opt_tol": 1e-6, "max_iter": 300,
                                  "block_size": 128, "randomize": False,
                                  "block_iters": 16}
    assert task.lam0_of(10_000, 100_000) == pytest.approx(0.047985, abs=5e-7)
    assert set(traffic["limits"]) == set(traffic["control"]) == {
        "solve_err", "polish_err", "loadings_err"}


def test_responses_are_heteroscedastic_and_drawn_from_the_seed():
    """The noise is ``σ_i ε_i`` with ``σ_i = |1 + f_i| / sqrt(mean (1 +
    f)²)``: redrawing the planted signal from the task's stream gives the
    standardized noise back, of mean 0 and variance 1; a seed gives the
    same responses, another seed others."""
    _, cfg, _ = _cut()
    seed = SEEDS[0]
    X = data.gauss_design(cfg, seed, CPU)
    Y = task.hetero_responses(X, 3, 5, seed)
    assert torch.equal(Y, task.hetero_responses(X, 3, 5, seed))
    assert not torch.equal(Y, task.hetero_responses(X, 3, 5, seed + 1))
    g = data.generator(seed, 6, CPU)
    sup = torch.topk(torch.rand((3, cfg["p"]), generator=g), 5,
                     dim=1).indices
    Bt = torch.zeros((3, cfg["p"]))
    Bt.scatter_(1, sup, torch.randn((3, 5), generator=g))
    F = Bt @ X.T
    sd = torch.abs(1 + F) / torch.sqrt(torch.mean((1 + F) ** 2, dim=1,
                                                  keepdim=True))
    eps = ((Y - F) / sd).double()
    assert float(torch.mean(sd ** 2)) == pytest.approx(1.0, rel=1e-5)
    assert abs(float(eps.mean())) < 0.1
    assert float(eps.var()) == pytest.approx(1.0, abs=0.1)
    # the noise grows with the signal: far from homoscedastic
    assert float(torch.amax(sd) / torch.amin(sd)) > 20


@pytest.mark.parametrize("seed", SEEDS)
def test_cut_cell_runs_correct_and_certified(seed):
    """The cut cell through the harness on the port's CPU path: every
    problem certified by the float64 polish and within each of the
    traffic's limits of the float64 reference fixed point."""
    rec, traffic = _run(seed)
    assert rec["problems"] and all(p.certified for p in rec["problems"])
    assert rec["checks"]["uncertified"]["value"] == 0
    for name, lim in traffic["limits"].items():
        assert rec["checks"][name]["value"] <= lim, (name, rec["checks"])
    assert rec["correct"]


def _rms(fn):
    """``fn`` with the residual replaced by ones: the column RMS."""
    def call(X, e, *a, **k):
        return fn(X, torch.ones_like(e), *a, **k)
    return call


def _f32_polish(X, y, beta, lam0, **_):
    """The float32 engine's own loading loop run on from the solve to its
    floor (outer and inner tolerance 1e-6), in the polish's place."""
    opts = tcd.IterLassoOptions(
        max_iter=40, opt_tol=1e-6, init_procedure="warm_start",
        options_cd=tcd.CDOptions(opt_tol=1e-6, randomize=False,
                                 block_size=128, block_iters=16))
    sol = tcd.feasible_lasso(X, y, lam0, options=opts, beta0=beta,
                             device=X.device)
    return polish.FeasiblePolishResult(
        beta=sol.x.double(), loadings=sol.penalty.weights.double(), gap=0.0,
        rel_gap=0.0, primal=0.0, rounds=1, loading_rounds=1,
        loading_rel_change=0.0, converged=True)


@pytest.mark.parametrize("fault", ["rms_loadings", "float32_polish",
                                   "uncertified"])
def test_cut_cell_with_a_planted_fault_is_not_correct(monkeypatch, fault):
    """Three faults turn ``correct`` false: the column RMS loadings in
    place of the re-estimated ones in both stages (the polish certifies
    the wrong fixed point: ``loadings_err`` and ``polish_err``), a float32
    polish (``polish_err``), and a polish that does not certify."""
    if fault == "rms_loadings":
        monkeypatch.setattr(lasso, "get_loadings_blocked",
                            _rms(lasso.get_loadings_blocked))
        monkeypatch.setattr(polish, "loadings_f64", _rms(polish.loadings_f64))
    elif fault == "float32_polish":
        monkeypatch.setattr(tcd, "polish_feasible_lasso", _f32_polish)
    else:
        real = tcd.polish_feasible_lasso

        def uncertified(*a, **k):
            return real(*a, **k)._replace(converged=False)

        monkeypatch.setattr(tcd, "polish_feasible_lasso", uncertified)
    rec, traffic = _run()
    assert not rec["correct"], rec["checks"]
    assert rec["failed"] >= 1
    over = {n for n, lim in traffic["limits"].items()
            if rec["checks"][n]["value"] > lim}
    want = {"rms_loadings": {"loadings_err", "polish_err"},
            "float32_polish": {"polish_err"}, "uncertified": set()}[fault]
    assert want <= over, rec["checks"]
    if fault == "uncertified":
        assert rec["checks"]["uncertified"]["value"] == len(rec["problems"])
    else:
        assert rec["checks"]["uncertified"]["value"] == 0


_NO_JAX = """
import sys
sys.path[:0] = [{root!r}, {tests!r}]
import cdbench.reference.feasible_lasso
print("REFERENCE", sorted({{m.split(".")[0] for m in sys.modules}}
                          & {{"coordinatedescent_jl_tpu_torch", "jax",
                             "jaxlib", "coordinatedescent_jl_tpu"}}))
import test_cdbench_feasible as cut
rec, _ = cut._run()
assert rec["correct"], rec["checks"]
from cdbench.run import forbidden_modules
print("FORBIDDEN", forbidden_modules())
"""


def test_a_run_loads_no_jax_and_the_reference_none_of_the_port():
    """In a fresh process: the reference module alone loads neither the
    port nor JAX, and a whole run of the cut cell loads no JAX."""
    root = Path(__file__).resolve().parents[1]
    res = subprocess.run(
        [sys.executable, "-c", _NO_JAX.format(root=str(root),
                                              tests=str(root / "tests"))],
        capture_output=True, text=True, timeout=600, cwd=root)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "REFERENCE []" in res.stdout
    assert "FORBIDDEN []" in res.stdout


def test_reference_fixed_point_meets_its_conditions():
    """The float64 reference at the cut: the coefficients meet the
    weighted Lasso's optimality conditions at the loadings, |X'r| = n·λ0·Γ
    on the support with the coefficients' signs and at most that off it,
    and the loadings are those of the residuals; the noise moves them
    away from the column RMS loadings (the start)."""
    _, cfg, traffic = _cut()
    state = task.prepare(cfg, traffic, SEEDS[1], CPU)
    y = state.Y[0].double()
    b, gam, ok = reference.fixed_point(state.X, y, state.lam0,
                                       torch.float64)
    assert ok
    n = state.X.shape[0]
    r = y - state.X.double() @ b
    g = solvers.xtr(state.X, r) / (n * state.lam0 * gam)
    sup = b != 0
    assert 0 < int(sup.sum()) < n
    assert float(torch.amax(torch.abs(g[sup] - torch.sign(b[sup])))) < 1e-9
    assert float(torch.amax(torch.abs(g[~sup]))) <= 1 + 1e-9
    want = torch.sqrt((r * r) @ state.X.double().square() / n)
    assert float(torch.amax(torch.abs(gam - want)) / torch.amax(want)) < 1e-11
    rms = reference.loadings(state.X, torch.ones_like(y))
    assert float(torch.amax(torch.abs(gam / rms - 1))) > 0.05
    assert state.lam0 == pytest.approx(math.sqrt(2 * math.log(2000) / 300))


# ---------------------------------------------------------------------------
# The metrics that read the spans and marks
# ---------------------------------------------------------------------------


def _tp(ops, host_events):
    return TracedProblem(ops=ops, spans=[("problem", 0.0, 1000.0)],
                         host=host_events, start=0.0, end=1000.0)


def _rec(*tps):
    return {"traced": [(tp, {}) for tp in tps]}


F32 = "cdt#loadings n=10000 p=100000 x_item=4 acc=4"
F64 = "cdt#loadings n=10000 p=100000 x_item=4 acc=8"


def test_loadings_roofline_reads_marks_over_the_spans_device_time():
    """Σ least time of the marks ÷ Σ device time of the operations that
    start inside the loadings spans; operations that start outside them
    do not count, whenever they end."""
    ops = [("sq", 10.0, 1010.0), ("mm", 1010.0, 2010.0),   # f32 sweep
           ("other", 2100.0, 2200.0),
           ("sq64", 3000.0, 9000.0), ("d2h", 9000.0, 9010.0),
           ("late", 9020.0, 9500.0)]
    host_events = [("cdt:feasible.loadings", 0.0, 2050.0), (F32, 1.0, 40.0),
                   ("cdt:cd.solve", 2050.0, 2900.0),
                   ("cdt:polish.loadings", 2950.0, 9015.0),
                   (F64, 2960.0, 3000.0)]
    rec = _rec(_tp(ops, host_events))
    nbytes = 4 * 10_000 * 100_000
    least = (max((nbytes + 4 * 110_000) / 3.35e12, 3e9 / 67e12)
             + max((nbytes + 8 * 110_000) / 3.35e12, 3e9 / 67e12))
    assert loadings_roofline.read(rec) == pytest.approx(
        100.0 * least / ((2000.0 + 6010.0) * 1e-6))
    # the float64 mark's flops bound against the float64 peak
    assert loadings_roofline.least_seconds(
        {"n": 10, "p": 10, "x_item": 4, "acc": 8}) == pytest.approx(
        max((400 + 160) / 3.35e12, 300 / 67e12))


def test_loadings_roofline_none_on_a_count_mismatch_or_nothing_to_read():
    ops = [("sq", 10.0, 20.0)]
    span = ("cdt:feasible.loadings", 0.0, 30.0)
    assert loadings_roofline.read(_rec(_tp(ops, [span]))) is None
    assert loadings_roofline.read(_rec(_tp(ops, [(F32, 1.0, 2.0)]))) is None
    assert loadings_roofline.read(_rec(
        _tp(ops, [span, (F32, 1.0, 2.0)]),
        _tp(ops, [span, (F32, 1.0, 2.0), (F64, 3.0, 4.0)]))) is None
    # a tree that opens neither (the parent of this metric)
    assert loadings_roofline.read(_rec(_tp(ops, []))) is None
    assert loadings_roofline.read({"traced": []}) is None
    # marks and spans but no device operation inside them
    assert loadings_roofline.read(_rec(_tp(
        [("sq", 40.0, 50.0)], [span, (F32, 1.0, 2.0)]))) is None


def test_loading_rounds_per_problem_counts_both_stages_rounds():
    a = _tp([], [("cdt:est.feasible_lasso", 0.0, 100.0),
                 ("cdt:feasible.round", 1.0, 10.0),
                 ("cdt:feasible.loadings", 8.0, 9.0),
                 ("cdt:feasible.round", 11.0, 20.0),
                 ("cdt:polish.loading_round", 30.0, 40.0)])
    b = _tp([], [("cdt:feasible.round", 1.0, 10.0),
                 ("cdt:polish.loading_round", 30.0, 40.0),
                 ("cdt:polish.loading_round", 41.0, 50.0),
                 ("cdt:polish.loading_round", 51.0, 60.0)])
    assert loading_rounds_per_problem.read(_rec(a, b)) == pytest.approx(3.5)
    # a tree without the spans reads nothing
    assert loading_rounds_per_problem.read(_rec(_tp([], [
        ("cdt:est.feasible_lasso", 0.0, 1.0)]))) is None
    assert loading_rounds_per_problem.read({"traced": []}) is None


def test_metrics_read_the_ranges_a_real_solve_opens(monkeypatch):
    """The names the port opens are the names the metrics read: a cut
    problem under a recording range opener, laid out as a trace."""
    from coordinatedescent_jl_tpu_torch.utils import host
    import contextlib

    clock = iter(range(10**9))
    ranges = []

    @contextlib.contextmanager
    def record_function(name):
        r = [name, float(next(clock)), None]
        ranges.append(r)
        try:
            yield
        finally:
            r[2] = float(next(clock))

    _, cfg, traffic = _cut()
    state = task.prepare(cfg, traffic, SEEDS[0], CPU)
    with monkeypatch.context() as m:
        m.setattr(host, "profiling", lambda: True)
        m.setattr(torch.profiler, "record_function", record_function)
        m.setattr(torch._C._profiler, "_RecordFunctionFast",
                  record_function)
        oc = task.solve(state, 0, run.Spans(CPU))
    assert oc.certified
    sweeps = [r for r in ranges
              if r[0] in ("cdt:feasible.loadings", "cdt:polish.loadings")]
    # one device operation at the start of each sweep's span
    ops = [("sweep", s, s + 0.5) for _, s, _ in sweeps]
    tp = _tp(ops, [tuple(r) for r in ranges])
    assert loadings_roofline.read(_rec(tp)) is not None
    rounds = loading_rounds_per_problem.read(_rec(tp))
    assert rounds == sum(1 for r in ranges if r[0] in (
        "cdt:feasible.round", "cdt:polish.loading_round")) >= 2
    assert len(sweeps) == len([r for r in ranges
                               if r[0].startswith("cdt#loadings ")])
