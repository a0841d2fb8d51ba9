"""The port's bench (``coordinatedescent_jl_tpu_torch/bench.py``) on the CPU:
its compact keys are bench.py's, each section gives its keys with its
certificates true at a cut shape (float64, the plain path), the two
output lines are assembled as bench.py assembles them, and the p = 1M
section's path and the row tier agree with the JAX package's sharded
tiers on the same inputs within 1e-9.  (The varying-coefficient section:
tests/test_torch_bench_vc.py.)"""

import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import coordinatedescent_jl_tpu as cd  # noqa: E402
from coordinatedescent_jl_tpu_torch import bench  # noqa: E402
from coordinatedescent_jl_tpu_torch.profile_paths import (  # noqa: E402
    bench_problem, group_bench_problem)

torch.set_num_threads(1)
CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]


def _f64(pr, *fields):
    return pr._replace(**{f: getattr(pr, f).double() for f in fields})


def _errors(extra):
    return {k: v for k, v in extra.items() if k.endswith("_error")}


def test_compact_keys_are_bench_py_s():
    """``COMPACT_KEYS`` is bench.py's ``_compact_keys``, read from its
    source (bench.py imports JAX at run time; it is not run)."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    found = [node.value for node in ast.walk(tree)
             if isinstance(node, ast.Assign)
             and any(isinstance(t, ast.Name) and t.id == "_compact_keys"
                     for t in node.targets)]
    assert len(found) == 1
    assert ast.literal_eval(found[0]) == bench.COMPACT_KEYS


def test_main_sections_give_their_keys():
    """The scan, the batched path, the polish, the X-traffic report and
    the three estimators with their polishes, on a cut bench problem."""
    bp = _f64(bench_problem(CPU, n=300, p=256, s=5, L=4), "X", "y")
    extra = {}
    t_path, t_pb, cert, t_first = bench.main_sections(
        extra, bench.Clock(CPU, False), bp)
    assert not _errors(extra)
    assert cert and 0 < t_pb < np.inf and t_path > 0 and t_first > 0
    for key in ("single_solve_s", "time_to_1e7_gap_s", "sqrt_lasso_s",
                "scaled_lasso_s", "feasible_lasso_s", "solve_achieved_x_gbs",
                "polish_s", "sqrt_polish_s", "scaled_polish_s",
                "feasible_polish_s"):
        assert extra[key] >= 0, key
    for key in ("final_point_rel_gap_polished", "scaled_rel_gap_polished",
                "feasible_rel_gap_polished", "sqrt_kkt_rel_polished"):
        assert extra[key] <= 1e-7, key
    for key in ("polish_converged", "sqrt_polish_converged",
                "scaled_polish_converged", "feasible_polish_converged"):
        assert extra[key] is True, key
    assert extra["final_point_rel_gap"] <= 1e-5


def test_group_section_gives_its_keys():
    gp = _f64(group_bench_problem(CPU, n=200, p=128, G=8, n_act=3), "X", "y")
    extra = {}
    bench.group_section(extra, bench.Clock(CPU, False), gp)
    assert not _errors(extra)
    assert extra["group_lasso_s"] > 0
    assert extra["group_kkt_rel_polished"] <= 1e-7
    assert extra["group_polish_converged"] is True
    assert extra["group_lasso_shape"] == {"n": 200, "p": 128, "G": 8,
                                          "active_groups": 3}


def test_oracle_section():
    out = bench.oracle_section(bench.Clock(CPU, False),
                               bench.SMALL._replace(oracle=(100, 200, 10)))
    assert out["oracle_cd_bench_s"] > 0 and out["ours_cd_bench_s"] > 0
    assert out["speedup"] > 0 and len(out["oracle_times_s"]) == 5
    assert out["oracle_solution_max_abs_diff"] < 1e-3


def _jax_opts():
    return cd.CDOptions(opt_tol=bench.OPT_TOL, randomize=False)


def _jmesh(axis):
    return Mesh(np.asarray(jax.devices()[:1]), (axis,))


def _problem(X, y, frac):
    Xt, yt = torch.as_tensor(X), torch.as_tensor(y)
    return bench.Problem(Xt, yt, frac * bench.lam_max(Xt, yt))


def test_sharded_tiers_match_jax():
    """The slice against the JAX package: the p = 1M section's solve and
    20-point batched path at a cut shape (n = 200, p = 2,048: 16 blocks),
    and the row tier, on a Gloo world of one, against JAX's
    ``parallel.lasso_sharded`` / ``lasso_path_sharded`` /
    ``lasso_row_sharded`` on a 1-device CPU mesh, float64, the same inputs
    and the λ the sections timed last: within 1e-9.  The 10,000 × 100,000
    section at a cut shape gives its keys."""
    rng = np.random.default_rng(31)
    n1, p1 = 200, 2048
    X1 = rng.standard_normal((n1, p1))
    b1 = np.zeros(p1)
    b1[rng.choice(p1, 5, replace=False)] = rng.standard_normal(5)
    y1 = X1 @ b1 + 0.3 * rng.standard_normal(n1)
    Xr = rng.standard_normal((400, 40))
    yr = Xr[:, :4] @ rng.standard_normal(4) + 0.3 * rng.standard_normal(400)
    shp = _f64(bench.sharded_problem(CPU, 200, 256), "X", "y")
    extra = {}
    ck = bench.Clock(CPU, False)
    with bench.world_of_one(CPU) as pdist:
        p1m = bench.p1m_section(extra, ck, _problem(X1, y1, 0.1), pdist)
        lam_r, x_r = bench.row_section(extra, ck, _problem(Xr, yr, 0.3),
                                       pdist)
        bench.sharded_section(extra, ck, shp, 5, pdist)
    assert not _errors(extra)
    for key in ("sharded_p1m_certified", "sharded_path_p1m_certified",
                "sharded_path_batched_certified"):
        assert extra[key] is True, key
    for key in ("sharded_p1m_s", "sharded_path_p1m_s", "row_sharded_1dev_s",
                "sharded_1dev_s", "group_sharded_1dev_s",
                "sharded_path_1dev_s"):
        assert extra[key] > 0, key
    assert extra["sharded_vs_single_max_abs_diff"] < 1e-5
    assert extra["row_sharded_vs_single_max_abs_diff"] < 1e-5

    lam1, x1 = p1m["lasso"]
    ref = cd.parallel.lasso_sharded(X1, y1, lam1, _jmesh("feature"),
                                    options=_jax_opts())
    np.testing.assert_allclose(x1.numpy(), np.asarray(ref.x), rtol=0,
                               atol=1e-9)
    grid, betas = p1m["path"]
    ref = cd.parallel.lasso_path_sharded(
        X1, y1, np.asarray(grid), _jmesh("feature"), options=_jax_opts(),
        standardize_X=False, path_batch=20, coarse_stride=19)
    assert betas.shape == (20, p1)
    np.testing.assert_allclose(betas.numpy(), np.asarray(ref.beta_path),
                               rtol=0, atol=1e-9)
    ref = cd.parallel.lasso_row_sharded(Xr, yr, lam_r, _jmesh("obs"),
                                        options=_jax_opts())
    np.testing.assert_allclose(x_r.numpy(), np.asarray(ref.x), rtol=0,
                               atol=1e-9)


def test_run_assembles_bench_py_s_lines(monkeypatch):
    """``run`` prints bench.py's lines: the compact keys in bench.py's
    order with the absent ones skipped, the headline the faster certified
    path, ``vs_baseline`` the oracle's ratio, and a section that raises
    recorded as ``<section>_error`` while the run goes on."""
    def main_sections(extra, ck, bp):
        extra.update(single_solve_s=0.5, solve_achieved_x_gbs=3.0)
        return 2.0, 1.5, True, 9.0

    def vc_section(extra, ck, vp):
        raise ValueError("boom")

    def group_section(extra, ck, gp):
        extra.update(group_lasso_s=0.25, group_kkt_rel_polished=1e-9)

    def tiers(extra, ck, sizes):
        extra.update(sharded_1dev_s=0.1, row_sharded_1dev_s=0.2)

    monkeypatch.setattr(bench, "main_sections", main_sections)
    monkeypatch.setattr(bench, "vc_section", vc_section)
    monkeypatch.setattr(bench, "group_section", group_section)
    monkeypatch.setattr(bench, "_tiers", tiers)
    monkeypatch.setattr(bench, "oracle_section", lambda ck, sizes: {
        "oracle_cd_bench_s": 3.0, "ours_cd_bench_s": 0.5, "speedup": 6.0})
    tiny = bench.SMALL._replace(main=(20, 64, 2, 3), vc=(20, 2, 3),
                                group=(20, 64, 8))
    full, compact = bench.run("cpu", tiny)
    assert full["metric"] == compact["metric"] == "lasso_path_wall_time_small"
    assert compact["value"] == 1.5 and compact["unit"] == "s"
    assert compact["vs_baseline"] == 6.0
    keys = list(compact["details"])
    assert keys == [k for k in bench.COMPACT_KEYS if k in keys]
    assert keys == ["path_scan_s", "path_batched_s", "path_batched_certified",
                    "compile_plus_run_s", "single_solve_s", "group_lasso_s",
                    "group_kkt_rel_polished", "sharded_1dev_s",
                    "row_sharded_1dev_s", "solve_achieved_x_gbs",
                    "oracle_cd_bench_s"]
    assert full["full_details"]["locpolyl1_error"] == "ValueError: boom"
    assert full["full_details"]["platform"] == "cpu"


def test_bench_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.run(None, bench.SMALL)
    with pytest.raises(SystemExit):
        bench.main([])
